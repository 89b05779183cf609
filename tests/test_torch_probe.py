"""Kernel K8's entry point and the port's cold-start probe
(vgtpu_torch/utils/cold_probe.py) against tools/probe_cold_tax.py's Pallas
probe kernel `k` (x * 2 + 1), run in interpret mode: exact, since x * 2 is
exact and the add rounds once on both sides."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores,
# and torch's thread pool oversubscribed them by orders of magnitude
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from vgtpu_torch.utils import cold_probe  # noqa: E402


def _pallas_probe(x):
    """tools/probe_cold_tax.py's PALLAS probe kernel, in interpret mode."""
    def k(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0 + 1.0

    return pl.pallas_call(k, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
                          interpret=True)(x)


def test_probe_affine_matches_pallas_probe():
    x = np.random.default_rng(5).normal(0, 1e3, cold_probe.SHAPE).astype(np.float32)
    ref = np.asarray(_pallas_probe(jnp.asarray(x)))
    got = cold_probe.probe_affine(torch.from_numpy(x))
    assert got.shape == ref.shape == cold_probe.SHAPE
    np.testing.assert_array_equal(got.numpy(), ref)


def test_k8_wrapper_refuses_cpu_tensors_and_other_devices():
    """The CUDA wrapper never runs the plain twin: a CPU tensor raises
    before any build or launch; the dispatcher refuses devices other than
    CUDA and the CPU."""
    from vgtpu_torch.ops.probe_cuda import K8, probe_affine_cuda

    before = K8.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        probe_affine_cuda(torch.zeros(cold_probe.SHAPE))
    assert K8.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        cold_probe.probe_affine(torch.zeros(cold_probe.SHAPE, device="meta"))


def _wrapper_calls():
    """The nine CUDA wrapper entry points: (kernel, call on tensors x)."""
    from vgtpu_torch.ops import (
        composite_cuda,
        composite_flat_cuda,
        coverage_cuda,
        coverage_resolve_cuda,
        coverage_slots_cuda,
        coverage_t_cuda,
        coverage_t_flat_cuda,
        probe_cuda,
    )

    flags = (False,) * 7
    return {
        "K1 cov_all_cuda": (coverage_cuda.K1, lambda x: coverage_cuda.cov_all_cuda(
            [x], 8, 128)),
        "K2 composite_bucket_cuda": (composite_cuda.K2, lambda x: (
            composite_cuda.composite_bucket_cuda(x, x, x, x, x, None, x, (1, 1, 1, 1),
                                                 tile_w=128, flags=flags))),
        "K3 coverage_chunks_res_cuda": (coverage_resolve_cuda.K3, lambda x: (
            coverage_resolve_cuda.coverage_chunks_res_cuda([x], [x], x, 16, 128, 2))),
        "K3 resolve_rows_cuda": (coverage_resolve_cuda.K3, lambda x: (
            coverage_resolve_cuda.resolve_rows_cuda(x, x, x, x, 16, 128, 2))),
        "K4 coverage_chunks_t_cuda": (coverage_t_cuda.K4, lambda x: (
            coverage_t_cuda.coverage_chunks_t_cuda(x, 8, 128))),
        "K5 coverage_chunks_t_flat_cuda": (coverage_t_flat_cuda.K5, lambda x: (
            coverage_t_flat_cuda.coverage_chunks_t_flat_cuda(x, 8, 128))),
        "K6 coverage_chunks_slots_cuda": (coverage_slots_cuda.K6, lambda x: (
            coverage_slots_cuda.coverage_chunks_slots_cuda(x, 8, 128))),
        "K7 composite_bucket_flat_cuda": (composite_flat_cuda.K7, lambda x: (
            composite_flat_cuda.composite_bucket_flat_cuda(x, x, None, x, tile_w=128,
                                                           flags=flags))),
        "K8 probe_affine_cuda": (probe_cuda.K8, probe_cuda.probe_affine_cuda),
    }


_WRAPPERS = ["K1 cov_all_cuda", "K2 composite_bucket_cuda",
             "K3 coverage_chunks_res_cuda", "K3 resolve_rows_cuda",
             "K4 coverage_chunks_t_cuda", "K5 coverage_chunks_t_flat_cuda",
             "K6 coverage_chunks_slots_cuda", "K7 composite_bucket_flat_cuda",
             "K8 probe_affine_cuda"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("wrapper", _WRAPPERS)
def test_cuda_wrappers_refuse_tensors_off_the_card(wrapper, device):
    """Every CUDA wrapper refuses a tensor that is not on a CUDA device (the
    CPU, or another device type) before any build or launch: no wrapper
    falls back to its plain twin."""
    calls = _wrapper_calls()
    assert sorted(calls) == sorted(_WRAPPERS)
    kernel, call = calls[wrapper]
    x = torch.zeros((4, 2, 4), device=device)
    before = kernel.launches
    with pytest.raises(ValueError, match=f"on {device}|{device}, not a CUDA|got {device}"):
        call(x)
    assert kernel.launches == before and kernel._fns is None


def test_check_tensor_names_each_refusal():
    """The wrappers' shared check: the fast path accepts, and each refusal
    (missing, another device, dtype or shape, layout, alignment) names
    itself."""
    from vgtpu_torch.utils.cuda_build import check_tensor

    t = torch.zeros((2, 8))
    check_tensor("w", "t", t, torch.float32, (2, 8), -1)        # the CPU's index
    check_tensor("w", "t", t, torch.float32, torch.Size((2, 8)), -1, 16)
    for args, msg in [((None, torch.float32, (2, 8), -1), "t missing"),
                      ((t, torch.float32, (2, 8), 0), "on cpu, expected cuda:0"),
                      ((t, torch.int32, (2, 8), -1), "must be torch.int32"),
                      ((t, torch.float32, (8, 2), -1), r"\(8, 2\), got"),
                      ((t.t(), torch.float32, (8, 2), -1), "contiguous")]:
        with pytest.raises(ValueError, match=msg):
            check_tensor("w", "t", *args)
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_tensor("w", "t", t.view(-1)[1:], torch.float32, (15,), -1, 16)


@pytest.mark.parametrize("name", sorted(cold_probe.PHASES))
def test_cold_probe_phase_programs_compile(name):
    code = cold_probe.phase_code(name)
    compile(code, f"<cold probe {name}>", "exec")
    assert 'sys.modules["jax"] = None' in code


def test_cold_probe_needs_a_card(capsys):
    """Without a CUDA device main() prints no result and returns 1, and a
    phase run in its own process fails instead of measuring the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cold_probe.main() == 1
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="phase torch failed"):
        cold_probe.run_phase("torch")


@pytest.mark.parametrize("mangled, name", [
    ("_ZN12_GLOBAL__N_124coverage_chunks_t_kernelEPKfPfiiii",
     "coverage_chunks_t_kernel"),
    ("_ZN12_GLOBAL__N_124coverage_chunks_t_kernelILb0EEvPKfPfiiii",
     "coverage_chunks_t_kernel"),
    ("_Z12probe_affinePKfPfi", "probe_affine"),
    ("vg_plain_symbol", "vg_plain_symbol"),
])
def test_sass_compare_base_name(mangled, name):
    from vgtpu_torch.utils.sass_compare import base_name

    assert base_name(mangled) == name


def test_sass_compare_parses_cuobjdump_text():
    """utils/sass_compare reads cuobjdump's listings: per kernel its
    instructions without addresses or encodings, and its registers."""
    from vgtpu_torch.utils.sass_compare import parse

    sass = """
\tcode for sm_90a
\t\tFunction : _Z1kPf
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe20000000800 */
        /*0010*/                   EXIT ;                          /* 0x000000000000794d */
\t\tFunction : _Z1jPf
        /*0000*/                   EXIT ;                          /* 0x000000000000794d */
"""
    res = """Resource usage:
 Common:
  GLOBAL:0
 Function _Z1kPf:
  REG:12 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:360 TEXTURE:0 SURFACE:0 SAMPLER:0
"""
    got = parse(sass, res)
    assert got == {"_Z1kPf": (["LDC R1, c[0x0][0x28] ;", "EXIT ;"], 12),
                   "_Z1jPf": (["EXIT ;"], -1)}


def test_sass_compare_delta_counts_changed_instructions():
    from vgtpu_torch.utils.sass_compare import delta

    a = ["LDS R2, [R3] ;", "FADD R4, R2, R5 ;", "EXIT ;"]
    b = ["LDS R2, [R3+0x400] ;", "FADD R4, R2, R5 ;", "EXIT ;"]
    assert delta(a, b) == "1 of 3 instructions, opcodes the same"
    assert delta(a, ["@P0 EXIT ;"] + a) == "1 of 4 instructions, opcodes different"
