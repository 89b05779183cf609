"""Command lists in vgtpu_torch (api/command_list.py) against vgtpu on the
CPU.

Each case runs a vgtpu test's own body over both packages
(tests/torch_mirror.py): the port must pass every assertion vgtpu's test
makes, and every frame the two runs end must have FramePlans equal bit for
bit, images within 2e-6 and the memo and layer counters equal after
each frame.  The cases are the 23 tests of
tests/test_command_list.py, the command-list execution paths of
tests/test_differential_fuzz.py (replay, cached second submit, save/load,
next to the direct paths they are held to) and the command-list cases of
test_entry.py, test_fp_cache.py, test_pathrec.py, test_semantics.py and
test_scenes.py."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores
torch.set_num_threads(1)

from tests.torch_mirror import mirror  # noqa: E402

COMMAND_LIST_TESTS = [
    "test_record_and_submit",
    "test_submit_respects_current_transform",
    "test_local_gradient_handles",
    "test_nested_submit",
    "test_cacheable_reuses_geometry_and_invalidates_on_scale",
    "test_cached_submit_pixel_identical_to_direct",
    "test_command_culling",
    "test_reset_command_list",
    "test_depth_limit",
    "test_cached_replay_preserves_clip_semantics",
    "test_direct_cl_recording_api",
    "test_command_list_ref",
    "test_cacheable_list_with_mergeable_draws",
    "test_cached_replay_under_outer_clip",
    "test_cacheable_dpr2_translate_after_cache",
    "test_dpr_change_invalidates_cache",
    "test_cached_replay_thin_stroke_alpha",
    "test_per_command_scissor_culling",
    "test_cached_replay_scissor_culling",
    "test_cache_build_never_culls",
    "test_command_list_save_load_roundtrip",
    "test_ops_memo_same_state_resubmit",
    "test_save_before_first_submit_and_attr_probes",
]


SAVES = {"test_command_list_save_load_roundtrip",
         "test_save_before_first_submit_and_attr_probes"}


@pytest.mark.parametrize("name", COMMAND_LIST_TESTS)
def test_command_list_matches_vgtpu(name, tmp_path):
    mirror("test_command_list", name, *((tmp_path,) if name in SAVES else ()))


@pytest.mark.parametrize("test,seed", [
    ("test_fuzz_all_execution_paths_agree", 11),
    ("test_fuzz_all_execution_paths_agree", 23),
    ("test_fuzz_all_execution_paths_agree", 37),
    ("test_fuzz_all_execution_paths_agree", 58),
    ("test_fuzz_all_execution_paths_agree_dpr2", 71),
    ("test_fuzz_all_execution_paths_agree_dpr2", 92),
])
def test_fuzz_execution_paths_match_vgtpu(test, seed, tmp_path):
    """One random program through every execution path (direct, immediate
    geometry, command-list replay, cached second submit, save/load into a
    fresh context, renderFrames), in both packages."""
    mirror("test_differential_fuzz", test, seed, tmp_path)


@pytest.mark.parametrize("module,name", [
    ("test_entry", "test_get_stats_counts_command_list_memory"),
    ("test_fp_cache", "test_app_pattern_steady_state_pixels_unchanged"),
    ("test_pathrec", "test_culling_respects_first_draw_transform"),
    ("test_semantics", "test_culling_keeps_partially_visible"),
    ("test_scenes", "test_tier5_full_frame"),
])
def test_command_list_cases_match_vgtpu(module, name):
    mirror(module, name)
