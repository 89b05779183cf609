# Copied from vgtpu/native/__init__.py: the jax-free host half of the PyTorch port.
"""ctypes loader for the native geometry engine (native/vg_native.cpp).

Builds the shared libraries on demand with g++ from the repo's shared
native/ sources into build/native/ (gitignored).
Everything degrades gracefully to the numpy implementations when the
toolchain is unavailable (VGTPU_NO_NATIVE=1 forces the numpy path).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
_SRC = os.path.join(_ROOT, "native", "vg_native.cpp")
_REC_SRC = os.path.join(_ROOT, "native", "vg_pathrec.c")
_BUILD = os.path.join(_ROOT, "build", "native")
_LIB = os.path.join(_BUILD, "libvgnative.so")
_REC_LIB = os.path.join(_BUILD, "_vgpathrec.so")

_lib = None
_tried = False
_rec_mod = None
_rec_tried = False


def pathrec():
    """The _vgpathrec CPython extension module (fast path-verb recorder), or
    None when the toolchain/headers are unavailable.  Built on demand like
    the ctypes library; VGTPU_NO_NATIVE disables it too (the pure-Python
    PathBuilder is the oracle)."""
    global _rec_mod, _rec_tried
    if _rec_mod is not None or _rec_tried:
        return _rec_mod
    _rec_tried = True
    if os.environ.get("VGTPU_NO_NATIVE") or os.environ.get("VGTPU_NO_PATHREC"):
        return None
    src = os.path.abspath(_REC_SRC)
    if not os.path.exists(src):
        return None
    def build() -> bool:
        import sysconfig

        inc = sysconfig.get_paths().get("include")
        return _compile_atomic(
            ["g++", "-O2", "-shared", "-fPIC", "-I", inc],
            src, _REC_LIB, "pathrec")

    def load():
        import importlib.util

        spec = importlib.util.spec_from_file_location("_vgpathrec", _REC_LIB)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    src_mtime = os.path.getmtime(src)
    if not os.path.exists(_REC_LIB) or os.path.getmtime(_REC_LIB) < src_mtime:
        if not build():
            return None
    try:
        _rec_mod = load()
    except Exception:  # noqa: BLE001
        # a stale artifact from another CPython (extension modules are
        # interpreter-version-specific, unlike the ctypes library): rebuild
        # for THIS interpreter and retry once
        if not build():
            return None
        try:
            _rec_mod = load()
        except Exception as e:  # noqa: BLE001
            print(f"[vgtpu_torch.native] pathrec load failed: {e}", file=sys.stderr)
            return None
    return _rec_mod


class _BinResult(ctypes.Structure):
    _fields_ = [
        ("chunk_edges", ctypes.POINTER(ctypes.c_float) * 6),
        ("chunk_entry", ctypes.POINTER(ctypes.c_int32) * 6),
        ("n_chunks", ctypes.c_int64 * 6),
        ("n_pools", ctypes.c_int32),
        ("entry_tile", ctypes.POINTER(ctypes.c_int32)),
        ("entry_backdrop", ctypes.POINTER(ctypes.c_float)),
        ("entry_kind", ctypes.POINTER(ctypes.c_int32)),
        ("entry_rule", ctypes.POINTER(ctypes.c_int32)),
        ("entry_aa", ctypes.POINTER(ctypes.c_int32)),
        ("entry_paint_kind", ctypes.POINTER(ctypes.c_int32)),
        ("entry_paint", ctypes.POINTER(ctypes.c_float)),
        ("entry_scissor", ctypes.POINTER(ctypes.c_float)),
        ("entry_image", ctypes.POINTER(ctypes.c_int32)),
        ("entry_op", ctypes.POINTER(ctypes.c_int32)),
        ("n_entries", ctypes.c_int64),
        ("tile_entries", ctypes.POINTER(ctypes.c_int32)),
        ("max_ops", ctypes.c_int32),
    ]


class _StrokeResult(ctypes.Structure):
    _fields_ = [
        ("pts", ctypes.POINTER(ctypes.c_float)),
        ("contour_off", ctypes.POINTER(ctypes.c_int64)),
        ("n_pts", ctypes.c_int64),
        ("n_contours", ctypes.c_int32),
    ]


def _compile_atomic(cmd_prefix: list, src: str, out: str, label: str) -> bool:
    """Compile to a process-unique temp file then os.replace into place:
    concurrent first-use processes (e.g. a self-provisioned virtual mesh)
    must never load a half-written artifact or clobber each other."""
    tmp = f"{out}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run(
            cmd_prefix + [src, "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)
        return True
    except Exception as e:  # noqa: BLE001
        print(f"[vgtpu_torch.native] {label} build failed: {e}", file=sys.stderr)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _build() -> bool:
    src = os.path.abspath(_SRC)
    if not os.path.exists(src):
        return False
    return _compile_atomic(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"],
        src, _LIB, "libvgnative")


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("VGTPU_NO_NATIVE"):
        return None
    src_mtime = os.path.getmtime(_SRC) if os.path.exists(_SRC) else 0
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < src_mtime:
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError as e:
        print(f"[vgtpu_torch.native] load failed: {e}", file=sys.stderr)
        return None
    c_f32p = ctypes.POINTER(ctypes.c_float)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    lib.vg_bin_frame.restype = ctypes.c_int
    lib.vg_bin_frame.argtypes = [
        c_f32p, c_i64p, c_f32p, c_i64p,
        c_i32p, c_i32p, c_i32p, c_i32p,
        c_f32p, c_f32p, c_i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        c_i32p, ctypes.c_int32,
        ctypes.POINTER(_BinResult),
    ]
    lib.vg_free_result.argtypes = [ctypes.POINTER(_BinResult)]
    lib.vg_stroke_outline.restype = ctypes.c_int
    lib.vg_stroke_outline.argtypes = [
        c_f32p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_float, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(_StrokeResult),
    ]
    lib.vg_free_stroke.argtypes = [ctypes.POINTER(_StrokeResult)]
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.vg_resolve_tiles.restype = ctypes.c_int
    lib.vg_resolve_tiles.argtypes = [
        c_i32p, ctypes.c_int64, ctypes.c_int32,
        c_i32p, c_i32p, c_i32p, c_f32p, c_f32p, c_f32p,
        ctypes.c_int32, c_u8p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        c_u8p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr_to_np(ptr, count: int, dtype) -> np.ndarray:
    """Copy `count` items from a ctypes pointer into a fresh numpy array.
    np.ctypeslib.as_array builds a new ctypes array TYPE per call (~10x
    slower); a single memmove into a preallocated array is the fast path
    (string_at + frombuffer().copy() costs two full copies)."""
    if count == 0:
        return np.zeros(0, dtype)
    dt = np.dtype(dtype)
    out = np.empty(count, dt)
    ctypes.memmove(out.ctypes.data, ctypes.addressof(ptr.contents),
                   count * dt.itemsize)
    return out


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _lp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def bin_frame_native(ops, width, height, tile_h, tile_w, pools=(2, 4, 8, 24)):
    """Run the native binner; returns raw (unpadded) result dict or None."""
    lib = get_lib()
    if lib is None:
        return None
    from vgtpu_torch.raster.binning import PAINT_NF

    # batched tri-list ops expand to one pseudo-op per triangle (vectorized)
    n = sum(len(op.tri_paints) if op.tri_paints is not None else 1 for op in ops)
    edge_parts, quad_parts = [], []
    edge_off = np.zeros(n + 1, np.int64)
    quad_off = np.zeros(n + 1, np.int64)
    kind = np.zeros(n, np.int32)
    rule = np.zeros(n, np.int32)
    aa = np.zeros(n, np.int32)
    pk = np.zeros(n, np.int32)
    paint = np.zeros((n, PAINT_NF), np.float32)
    sciss = np.zeros((n, 4), np.float32)
    image = np.full(n, -1, np.int32)
    i = 0
    for op in ops:
        if op.tri_paints is not None:
            k = len(op.tri_paints)
            edge_parts.append(np.ascontiguousarray(op.edges, np.float32))
            edge_off[i + 1 : i + k + 1] = edge_off[i] + 3 * np.arange(1, k + 1)
            quad_off[i + 1 : i + k + 1] = quad_off[i]
            kind[i : i + k] = op.kind
            rule[i : i + k] = op.fill_rule
            aa[i : i + k] = 1 if op.aa else 0
            pk[i : i + k] = op.paint_kind
            paint[i : i + k] = op.tri_paints
            sc = op.scissor if op.scissor is not None else (0.0, 0.0, float(width), float(height))
            sciss[i : i + k] = sc
            image[i : i + k] = op.image_id
            i += k
            continue
        e = op.edges if (op.edges is not None and op.paint_kind != 3) else None
        q = op.tex_quads if op.paint_kind == 3 else None
        if e is not None and len(e):
            edge_parts.append(np.ascontiguousarray(e, np.float32))
        edge_off[i + 1] = edge_off[i] + (len(e) if e is not None else 0)
        if q is not None and len(q):
            quad_parts.append(np.ascontiguousarray(q, np.float32))
        quad_off[i + 1] = quad_off[i] + (len(q) if q is not None else 0)
        kind[i] = op.kind
        rule[i] = op.fill_rule
        aa[i] = 1 if op.aa else 0
        pk[i] = op.paint_kind
        if op.paint is not None:
            paint[i] = op.paint
        sc = op.scissor if op.scissor is not None else (0.0, 0.0, float(width), float(height))
        sciss[i] = sc
        image[i] = op.image_id
        i += 1

    edges = (np.concatenate(edge_parts, axis=0) if edge_parts
             else np.zeros((0, 4), np.float32))
    tquads = (np.concatenate(quad_parts, axis=0) if quad_parts
              else np.zeros((0, 12), np.float32))
    edges = np.ascontiguousarray(edges, np.float32)
    tquads = np.ascontiguousarray(tquads, np.float32)

    res = _BinResult()
    pool_arr = np.asarray(pools, np.int32)
    if len(pool_arr) > 6:
        raise ValueError(
            f"at most 6 chunk pools supported (native MAX_POOLS), got {len(pool_arr)}")
    rc = lib.vg_bin_frame(
        _fp(edges), _lp(edge_off), _fp(tquads), _lp(quad_off),
        _ip(kind), _ip(rule), _ip(aa), _ip(pk),
        _fp(paint), _fp(sciss), _ip(image),
        n, width, height, tile_h, tile_w,
        _ip(pool_arr), len(pool_arr),
        ctypes.byref(res),
    )
    if rc != 0:
        return None

    ne = int(res.n_entries)
    ntx = -(-width // tile_w)
    nty = -(-height // tile_h)
    T = ntx * nty
    mo = int(res.max_ops)

    def arr(ptr, shape, dtype):
        n = int(np.prod(shape))
        if n == 0:
            return np.zeros(shape, dtype)
        return _ptr_to_np(ptr, n, dtype).reshape(shape)

    chunk_pools = []
    for pi, ch in enumerate(pools):
        ncp = int(res.n_chunks[pi])
        chunk_pools.append((
            arr(res.chunk_edges[pi], (ncp, int(ch), 4), np.float32),
            arr(res.chunk_entry[pi], (ncp,), np.int32),
        ))
    out = {
        "chunk_pools": chunk_pools,
        "entry_tile": arr(res.entry_tile, (ne,), np.int32),
        "entry_backdrop": arr(res.entry_backdrop, (ne, tile_h), np.float32),
        "entry_kind": arr(res.entry_kind, (ne,), np.int32),
        "entry_rule": arr(res.entry_rule, (ne,), np.int32),
        "entry_aa": arr(res.entry_aa, (ne,), np.int32),
        "entry_paint_kind": arr(res.entry_paint_kind, (ne,), np.int32),
        "entry_paint": arr(res.entry_paint, (ne, PAINT_NF), np.float32),
        "entry_scissor": arr(res.entry_scissor, (ne, 4), np.float32),
        "entry_image": arr(res.entry_image, (ne,), np.int32),
        "entry_op": arr(res.entry_op, (ne,), np.int32),
        "tile_entries": arr(res.tile_entries, (T, mo), np.int32),
        "n_entries": ne,
        "max_ops": mo,
        # compact per-pseudo-op tables (raw entry_op indexes these): the
        # device upload ships these instead of the dense per-entry expansions
        "pop": {
            "kind": kind, "rule": rule, "aa": aa, "paint_kind": pk,
            "paint": paint, "scissor": sciss,
        },
    }
    lib.vg_free_result(ctypes.byref(res))
    return out


def stroke_outline_native(pts, closed, width, cap, join, scale, tol):
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, np.float32)
    res = _StrokeResult()
    rc = lib.vg_stroke_outline(
        _fp(pts), len(pts), 1 if closed else 0,
        ctypes.c_float(width), cap, join,
        ctypes.c_float(scale), ctypes.c_float(tol),
        ctypes.byref(res),
    )
    if rc != 0 or res.n_contours == 0:
        if res.n_contours == 0:
            return []
        return None
    off = _ptr_to_np(res.contour_off, res.n_contours + 1, np.int64)
    flat = _ptr_to_np(res.pts, int(res.n_pts) * 2, np.float32).reshape(-1, 2)
    contours = [flat[off[i] : off[i + 1]].copy() for i in range(res.n_contours)]
    lib.vg_free_stroke(ctypes.byref(res))
    return contours


class _BakeResult(ctypes.Structure):
    _fields_ = [
        ("verts", ctypes.POINTER(ctypes.c_float)),
        ("subpaths", ctypes.POINTER(ctypes.c_int32)),
        ("n_verts", ctypes.c_int64),
        ("n_subpaths", ctypes.c_int32),
    ]


def _bind_bake(lib):
    if getattr(lib, "_bake_bound", False):
        return
    c_f32p = ctypes.POINTER(ctypes.c_float)
    c_f64p = ctypes.POINTER(ctypes.c_double)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    lib.vg_bake_path.restype = ctypes.c_int
    lib.vg_bake_path.argtypes = [
        c_i32p, ctypes.c_int32,
        c_f64p, c_f64p, c_f64p, c_i64p, c_f32p,
        ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(_BakeResult),
    ]
    lib.vg_free_bake.argtypes = [ctypes.POINTER(_BakeResult)]
    lib._bake_bound = True


def bake_path_native(verbs, simple_flat, cubic_flat, arc_flat, poly_args,
                     poly_pool, scale, tol):
    """Native PathBuilder.bake; returns (verts (V,2) f32, subs (S,3) i32)
    or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    _bind_bake(lib)
    verbs = np.ascontiguousarray(verbs, np.int32)
    sf = np.ascontiguousarray(simple_flat, np.float64)
    cf = np.ascontiguousarray(cubic_flat, np.float64)
    af = np.ascontiguousarray(arc_flat, np.float64)
    pa = np.ascontiguousarray(poly_args, np.int64)
    pp = np.ascontiguousarray(poly_pool, np.float32)
    res = _BakeResult()
    rc = lib.vg_bake_path(
        _ip(verbs), len(verbs),
        sf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        af.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _lp(pa), _fp(pp),
        ctypes.c_float(scale), ctypes.c_float(tol),
        ctypes.byref(res),
    )
    if rc != 0:
        return None
    nv, ns = int(res.n_verts), int(res.n_subpaths)
    if nv == 0:
        lib.vg_free_bake(ctypes.byref(res))
        return np.zeros((0, 2), np.float32), np.zeros((0, 3), np.int32)
    verts = _ptr_to_np(res.verts, nv * 2, np.float32).reshape(nv, 2)
    subs = _ptr_to_np(res.subpaths, max(ns, 1) * 3, np.int32).reshape(-1, 3)[:ns]
    lib.vg_free_bake(ctypes.byref(res))
    return verts, subs


class _GeomResult(ctypes.Structure):
    _fields_ = [
        ("edges", ctypes.POINTER(ctypes.c_float)),
        ("piece_off", ctypes.POINTER(ctypes.c_int64)),
        ("piece_draw", ctypes.POINTER(ctypes.c_int32)),
        ("n_edges", ctypes.c_int64),
        ("n_pieces", ctypes.c_int64),
    ]


def _bind_geom(lib):
    if getattr(lib, "_geom_bound", False):
        return
    c_f32p = ctypes.POINTER(ctypes.c_float)
    c_f64p = ctypes.POINTER(ctypes.c_double)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    lib.vg_frame_geom.restype = ctypes.c_int
    lib.vg_frame_geom.argtypes = [
        c_i32p, c_i64p, c_f64p, c_i64p, c_f64p, c_i64p, c_f64p, c_i64p,
        c_i64p, c_i64p, c_f32p,
        c_f32p, c_f32p, ctypes.c_int32,
        c_i32p, c_i32p, c_f32p, c_f32p, c_i32p, c_i32p, c_f32p,
        ctypes.c_float, ctypes.c_int32,
        ctypes.POINTER(_GeomResult),
    ]
    lib.vg_free_geom.argtypes = [ctypes.POINTER(_GeomResult)]
    lib._geom_bound = True


def frame_geom(snaps: list, draws: list, stroke_tol: float):
    """Batched frame geometry: bake + transform + fill/stroke edge assembly
    for every deferred draw in ONE native call.

    snaps: list of PathBuilder.snapshot() dicts.
    draws: list of (snap_idx, mode, xform6 f32[6], width, cap, join, scale).
    Returns (edges (E,4) f32, piece_off (NP+1) i64, piece_draw (NP,) i32)
    or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    _bind_geom(lib)
    P = len(snaps)
    D = len(draws)
    verbs = np.concatenate([s["verbs"] for s in snaps]) if P else np.zeros(0, np.int32)
    sf = np.concatenate([s["sf"] for s in snaps]) if P else np.zeros(0, np.float64)
    cf = np.concatenate([s["cf"] for s in snaps]) if P else np.zeros(0, np.float64)
    af = np.concatenate([s["af"] for s in snaps]) if P else np.zeros(0, np.float64)
    pp_parts = [s["pp"] for s in snaps if len(s["pp"])]
    pp = (np.concatenate(pp_parts, axis=0) if pp_parts else np.zeros((0, 2), np.float32))
    # poly args carry ABSOLUTE offsets into the shared pool
    pa_parts = []
    pool_base = 0
    for s in snaps:
        pa = s["pa"]
        if len(pa):
            pa = pa.copy()
            pa[:, 0] += pool_base
        pa_parts.append(pa)
        pool_base += len(s["pp"])
    pa = (np.concatenate(pa_parts, axis=0) if pa_parts else np.zeros((0, 2), np.int64))

    def offs(key, per):
        o = np.zeros(P + 1, np.int64)
        for i, s in enumerate(snaps):
            o[i + 1] = o[i] + len(s[key]) // per if per > 1 else o[i] + len(s[key])
        return o

    verbs_off = offs("verbs", 1)
    sf_off = offs("sf", 2)
    cf_off = offs("cf", 8)
    af_off = offs("af", 6)
    pa_off = np.zeros(P + 1, np.int64)
    for i, s in enumerate(snaps):
        pa_off[i + 1] = pa_off[i] + len(s["pa"])

    scale = np.asarray([s["scale"] for s in snaps], np.float32)
    tol = np.asarray([s["tol"] for s in snaps], np.float32)

    cols = tuple(zip(*draws)) if D else ((),) * 7
    dpath = np.asarray(cols[0], np.int32)
    dmode = np.asarray(cols[1], np.int32)
    dxf = np.asarray(cols[2], np.float32).reshape(D, 6)
    dwidth = np.asarray(cols[3], np.float32)
    dcap = np.asarray(cols[4], np.int32)
    djoin = np.asarray(cols[5], np.int32)
    dscale = np.asarray(cols[6], np.float32)

    verbs = np.ascontiguousarray(verbs)
    sf = np.ascontiguousarray(sf)
    cf = np.ascontiguousarray(cf)
    af = np.ascontiguousarray(af)
    pa = np.ascontiguousarray(pa)
    pp = np.ascontiguousarray(pp)

    res = _GeomResult()
    rc = lib.vg_frame_geom(
        _ip(verbs), _lp(verbs_off),
        sf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), _lp(sf_off),
        cf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), _lp(cf_off),
        af.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), _lp(af_off),
        _lp(pa), _lp(pa_off), _fp(pp),
        _fp(scale), _fp(tol), P,
        _ip(dpath), _ip(dmode), _fp(dxf), _fp(dwidth), _ip(dcap), _ip(djoin),
        _fp(dscale),
        ctypes.c_float(stroke_tol), D,
        ctypes.byref(res),
    )
    if rc != 0:
        return None
    edges = _ptr_to_np(res.edges, int(res.n_edges) * 4, np.float32).reshape(-1, 4)
    piece_off = _ptr_to_np(res.piece_off, int(res.n_pieces) + 1, np.int64)
    piece_draw = _ptr_to_np(res.piece_draw, int(res.n_pieces), np.int32)
    lib.vg_free_geom(ctypes.byref(res))
    return edges, piece_off, piece_draw


def resolve_tiles(tile_entries, plan, view_static: bool, static_clip: bool):
    """Native per-tile entry resolution (static clip, trailing prune,
    occlusion, depth cap) — the host side of compute_tile_buckets minus the
    bucket grouping.  Returns (resolved tile_entries, tile_fancy u8, capped
    tile count) or None when the native lib is unavailable.  Mirrors the
    numpy passes exactly (parity-tested in tests/test_native.py)."""
    lib = get_lib()
    if lib is None:
        return None
    te = np.ascontiguousarray(tile_entries, np.int32).copy()
    T, MO = te.shape
    ne = plan.entry_backdrop.shape[0]
    bd = (plan.entry_backdrop_pan
          if view_static and plan.entry_backdrop_pan is not None
          else plan.entry_backdrop)
    bd = np.ascontiguousarray(bd, np.float32)
    has_edges = np.zeros(ne, np.uint8)
    for _ce, cent in plan.chunk_pools:
        has_edges[np.asarray(cent)] = 1
    fancy = np.zeros(T, np.uint8)
    ek = np.ascontiguousarray(plan.entry_kind, np.int32)
    er = np.ascontiguousarray(plan.entry_rule, np.int32)
    epk = np.ascontiguousarray(plan.entry_paint_kind, np.int32)
    ep = np.ascontiguousarray(plan.entry_paint, np.float32)
    esc = np.ascontiguousarray(plan.entry_scissor, np.float32)
    ntx = max(1, -(-plan.width // plan.tile_w))
    capped = lib.vg_resolve_tiles(
        _ip(te), T, MO,
        _ip(ek), _ip(er), _ip(epk), _fp(ep), _fp(esc), _fp(bd),
        bd.shape[1], has_edges.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ne,
        plan.width, plan.height * plan.supersample, plan.tile_w, plan.tile_h,
        ntx, int(plan.depth_cap or 0), int(view_static), int(static_clip),
        fancy.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return te, fancy.astype(bool), int(capped)
