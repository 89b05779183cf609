# Copied from vgtpu/api/config.py: the jax-free host half of the PyTorch port.
# The fields are vgtpu's; in the port use_pallas, device_sampling, frame_memo,
# paint_memo, incremental_bin and layer_memo have no effect yet (ROADMAP.md Q1).
"""Runtime configuration (reference: ContextConfig, include/vg/vg.h:325-337,
defaults at vg.cpp:719-730) plus TPU-specific knobs.

The reference's compile-time VG_CONFIG_* macros (vg.h:7-45) become runtime
fields here — there is no preprocessor in a jitted pipeline; anything that
affects compiled-program shapes is a bucket size.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ContextConfig:
    # --- reference-parity fields (vg.cpp:719-730 defaults) ---
    max_gradients: int = 64
    max_image_patterns: int = 64
    max_fonts: int = 8
    max_state_stack_size: int = 32
    max_images: int = 16
    max_command_lists: int = 256
    max_vb_vertices: int = 65536          # kept for stats parity; no 16-bit index limit here
    font_atlas_image_flags: int = 0        # ImageFlags; filled by context default
    max_command_list_depth: int = 16
    reset_view_transform_on_end: bool = True

    # --- reference compile-time config equivalents ---
    force_aa_off: bool = False             # VG_CONFIG_FORCE_AA_OFF (vg.h:19)
    enable_shape_caching: bool = True      # VG_CONFIG_ENABLE_SHAPE_CACHING (vg.h:11)
    command_list_preserve_state: bool = False  # VG_CONFIG_COMMAND_LIST_PRESERVE_STATE (vg.h:34)
    min_font_size: float = 4.0             # VG_CONFIG_MIN_FONT_SIZE (vg.cpp:44)

    # --- TPU pipeline knobs ---
    tile_h: int = 8                        # one f32 VPU tile = 8 sublanes
    tile_w: int = 128                      # x 128 lanes
    edges_per_chunk: int = 8               # numpy-oracle chunk size
    chunk_pools: tuple = ()                # native binner chunk-size pools;
                                           # () = pick by supersample mode:
                                           # (2,4,8,24) at ss=1,
                                           # (2,4,6,12,24) at ss>1 (vgtpu's
                                           # TPU sweeps chose both)
    max_ops_per_tile_cap: int = 256        # hard safety cap on composite depth
    tess_tol: float = 0.25                 # tessellation tolerance in px (vg.cpp:763)
    fringe: float = 1.0                    # AA fringe reference width in px (vg.cpp:764)
    use_pallas: bool = True                # Pallas fine raster (False = pure-XLA path)
    device_sampling: bool = True           # textures sampled on device (MXU hat-weight
                                           # matmuls); False = host numpy sampler
    frame_memo: bool = True                # re-recorded identical frames reuse the
                                           # resident device plan (skip bin/sample/upload)
    paint_memo: bool = True                # re-recorded frames whose ONLY delta is
                                           # solid/gradient paint values patch the
                                           # resident plan's paint tables (skip
                                           # finalize/bin/sample, upload ~KBs) —
                                           # color/alpha animation at memo-hit cost.
                                           # Requires frame_memo.
    incremental_bin: bool = True           # per-op bin-piece cache: re-recorded frames
                                           # re-bin only ops whose content changed
                                           # (raster/binning.bin_frame_incremental)
    layer_memo: bool = True                # static-prefix resident layer: when frames
                                           # re-record an identical op prefix (cached
                                           # command list + immediate UI, the reference's
                                           # clCacheRender pattern vg.cpp:5845-6120),
                                           # the prefix bakes ONCE to device tiles and
                                           # later frames bin/upload/composite only the
                                           # dynamic suffix over them.  Requires
                                           # frame_memo (shares its fingerprints).
    layer_min_prefix: int = 16             # min stable-prefix ops worth a layer bake
    coverage_supersample: int = 1          # y-supersampling factor (1/2/4/8): >1 applies
                                           # the fill rule per sub-row for conflation-free
                                           # self-intersection coverage (the reference's
                                           # triangle meshes never conflate; analytic
                                           # box-filter coverage does at overlap pixels).
                                           # ~ss x coverage cost; XLA composite path.
    precision: str = "float32"

    def __post_init__(self) -> None:
        assert self.tile_w in (128, 256), "tile width must be a lane multiple"
        assert self.tile_h % 8 == 0, "tile height must be a sublane multiple"
        assert self.coverage_supersample in (1, 2, 4, 8), "supersample must be 1/2/4/8"
        if not self.chunk_pools:
            object.__setattr__(
                self, "chunk_pools",
                (2, 4, 8, 24) if self.coverage_supersample == 1
                else (2, 4, 6, 12, 24))
