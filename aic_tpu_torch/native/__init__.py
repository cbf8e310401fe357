"""Native (C++) host components, bound via ctypes (port of
`aic_tpu/native/__init__.py`).

The mesher's hot loops and the reference-procedure relight are host C++,
as in `aic_tpu`: `triangulate.cpp` (the no-T-junction plane
triangulator), `space_mesher.cpp` (whole-space greedy face rectangles)
and `ref_relight.cpp` (the reference's `evaluate_light` procedure on
this host's CPU, the denominator of `relight_vs_reference_ratio`). The
sources are copies of `aic_tpu`'s.

Each source is compiled by `g++` with `aic_tpu`'s flags into a shared
library under `aic_tpu_torch/_build/` at first use, keyed by a hash of
the source and the flags (as `kernels.py` builds the CUDA kernels). A
failed build raises with the compiler's output, and so does a native
call that reports an error: nothing falls back. `_triangulate_py` and
the greedy loop of `mesh.mesher._mesh_arrays` are the plain versions the
tests hold the native code against; no path picks them silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent / "_build"

#: `aic_tpu`'s g++ flags for each source.
CXX_FLAGS = {
    "triangulate": ("-O2", "-shared", "-fPIC", "-std=c++17"),
    "space_mesher": ("-O2", "-shared", "-fPIC", "-std=c++17"),
    "ref_relight": ("-O2", "-fopenmp", "-shared", "-fPIC", "-std=c++17"),
}

_LIBS: dict[str, ctypes.CDLL] = {}

_p8 = ctypes.POINTER(ctypes.c_uint8)
_p8s = ctypes.POINTER(ctypes.c_int8)
_p16 = ctypes.POINTER(ctypes.c_uint16)
_pf = ctypes.POINTER(ctypes.c_float)
_p32 = ctypes.POINTER(ctypes.c_int32)
_p64 = ctypes.POINTER(ctypes.c_int64)
_pint = ctypes.POINTER(ctypes.c_int)

#: C signatures: (restype, argtypes) of each library's entry point.
_SIGNATURES = {
    "triangulate": ("triangulate_plane", ctypes.c_int,
                    [_p8, _p16, ctypes.c_int, ctypes.c_int, _pf, _p32, _p16, ctypes.c_int, ctypes.c_int,
                     _pint, _pint]),
    "space_mesher": ("mesh_space_greedy", ctypes.c_int,
                     [_p16, ctypes.c_int, ctypes.c_int, ctypes.c_int, _p8, _p8, _p32, ctypes.c_int, _pint]),
    "ref_relight": ("ref_relight_run", ctypes.c_double,
                    [ctypes.c_int, ctypes.c_int, ctypes.c_int, _p32, ctypes.c_int, _p8, _p8, _pf, _pf, _pf, _pf,
                     ctypes.c_int, ctypes.c_int, _p8s, _p8, _p8, _pf, _p64, _p8]),
}


def _cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the native mesher and reference relight need a C++ compiler")
    return path


def library_path(name: str) -> Path:
    """Where `<name>.cpp` builds to: `_build/lib<name>-<hash of source and
    flags>.so`."""
    src = HERE / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS[name]).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load `native/<name>.cpp`; raises
    with the compiler's output when the build fails."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        res = subprocess.run([_cxx(), *CXX_FLAGS[name], str(HERE / f"{name}.cpp"), "-o", str(tmp)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {name}.cpp:\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    fn_name, restype, argtypes = _SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.restype = restype
    fn.argtypes = argtypes
    _LIBS[name] = lib
    return lib


def native_available() -> bool:
    """Whether every native library builds and loads here (`aic_tpu`
    native/__init__.py:124). A failed build is not remembered: a caller
    that needs the library then raises with the compiler's output."""
    try:
        for name in CXX_FLAGS:
            load(name)
    except (RuntimeError, OSError):
        return False
    return True


def _cp(a: np.ndarray, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty))


def mesh_space_greedy(contents, visible, opaque_faces) -> np.ndarray:
    """Native whole-space greedy face-rect extraction (space_mesher.cpp).

    contents: u16[X,Y,Z]; visible: bool[P]; opaque_faces: bool[P,6].
    Returns i32[N,7] rows [face, layer, u0, v0, du, dv, block_id]."""
    lib = load("space_mesher")
    contents = np.ascontiguousarray(contents, np.uint16)
    visible = np.ascontiguousarray(visible, np.uint8)
    opaque = np.ascontiguousarray(opaque_faces, np.uint8)
    sx, sy, sz = contents.shape
    cap = max(int(visible[contents].sum()) * 6 + 64, 1024)
    out = np.empty((cap, 7), np.int32)
    n = ctypes.c_int()
    rc = lib.mesh_space_greedy(_cp(contents, ctypes.c_uint16), sx, sy, sz, _cp(visible, ctypes.c_uint8),
                               _cp(opaque, ctypes.c_uint8), _cp(out, ctypes.c_int32), cap, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"mesh_space_greedy: {cap} rows were too few (rc {rc})")
    return out[: n.value].copy()


def triangulate_plane(mask: np.ndarray, ids: np.ndarray):
    """No-T-junction triangulation of a mesh plane (triangulate.cpp).

    mask: bool[H, W]; ids: u16[H, W]. Returns (verts f32[N,2],
    tris i32[M,3], tri_ids u16[M]). See triangulate.cpp for the
    algorithm and its contract with the reference's planar
    triangulator."""
    lib = load("triangulate")
    mask = np.ascontiguousarray(mask, np.uint8)
    ids = np.ascontiguousarray(ids, np.uint16)
    h, w = mask.shape
    n_cells = int(mask.sum())
    # Capacity: per rect at most 1 centre + perimeter verts <= 1 + 4 cells.
    max_v = 8 * n_cells + 8
    max_t = 8 * n_cells + 8
    verts = np.empty((max_v, 2), np.float32)
    tris = np.empty((max_t, 3), np.int32)
    tri_ids = np.empty(max_t, np.uint16)
    nv = ctypes.c_int()
    nt = ctypes.c_int()
    rc = lib.triangulate_plane(_cp(mask, ctypes.c_uint8), _cp(ids, ctypes.c_uint16), h, w,
                               _cp(verts, ctypes.c_float), _cp(tris, ctypes.c_int32),
                               _cp(tri_ids, ctypes.c_uint16), max_v, max_t, ctypes.byref(nv), ctypes.byref(nt))
    if rc != 0:
        raise RuntimeError(f"triangulate_plane: {max_v} vertices or {max_t} triangles were too few (rc {rc})")
    return verts[: nv.value].copy(), tris[: nt.value].copy(), tri_ids[: nt.value].copy()


def _triangulate_py(mask, ids):
    """The plain version of `triangulate_plane`, with the same output
    contract (`aic_tpu`'s fall-back; here only the tests call it)."""
    h, w = mask.shape
    used = np.zeros_like(mask, bool)
    verts, tris, tri_ids = [], [], []
    for u0 in range(h):
        for v0 in range(w):
            if not mask[u0, v0] or used[u0, v0]:
                continue
            bid = ids[u0, v0]
            dv = 1
            while v0 + dv < w and mask[u0, v0 + dv] and not used[u0, v0 + dv] and ids[u0, v0 + dv] == bid:
                dv += 1
            du = 1
            while u0 + du < h and all(
                mask[u0 + du, v] and not used[u0 + du, v] and ids[u0 + du, v] == bid
                for v in range(v0, v0 + dv)
            ):
                du += 1
            used[u0 : u0 + du, v0 : v0 + dv] = True
            center = len(verts)
            verts.append((u0 + du / 2.0, v0 + dv / 2.0))
            ring = []
            for v in range(v0, v0 + dv):
                ring.append(len(verts))
                verts.append((u0, v))
            for u in range(u0, u0 + du):
                ring.append(len(verts))
                verts.append((u, v0 + dv))
            for v in range(v0 + dv, v0, -1):
                ring.append(len(verts))
                verts.append((u0 + du, v))
            for u in range(u0 + du, u0, -1):
                ring.append(len(verts))
                verts.append((u, v0))
            n = len(ring)
            for k in range(n):
                tris.append((center, ring[k], ring[(k + 1) % n]))
                tri_ids.append(bid)
    return (
        np.asarray(verts, np.float32).reshape(-1, 2),
        np.asarray(tris, np.int32).reshape(-1, 3),
        np.asarray(tri_ids, np.uint16),
    )


# ---------------------------------------------------------------------------
# Reference-procedure relight denominator (ref_relight.cpp)
# ---------------------------------------------------------------------------


def ref_relight_state(state, return_light: bool = False):
    """Run the reference `evaluate_light` procedure (C++, this host's
    CPU, OpenMP) on a port `SpaceState` on any device. Returns (seconds,
    updates), or with `return_light` (seconds, updates, light
    u8[X,Y,Z,4]).

    The state's tables are copied to the host once; the chart is the
    port's `light/chart.py`, shaped as `aic_tpu`'s `_chart_host` shapes
    it. Same scene tables, chart and packed-light encoding as the card's
    relight; the algorithm follows updater.rs (ref_relight.cpp's
    header)."""
    from ..light.update import _chart_host

    lib = load("ref_relight")
    t = state.tables
    contents = np.ascontiguousarray(state.contents.cpu().numpy(), np.int32)
    sx, sy, sz = contents.shape
    visible = np.ascontiguousarray(t.visible.cpu().numpy(), np.uint8)
    opaque_all = np.ascontiguousarray(t.opaque_faces.cpu().numpy().all(-1), np.uint8)
    face_rows = np.ascontiguousarray(t.light_face_rows.cpu().numpy(), np.float32)
    emission = np.ascontiguousarray(t.light_emission.cpu().numpy(), np.float32)
    mean_alpha = np.ascontiguousarray(t.face_colors[:, 6, 3].cpu().numpy(), np.float32)
    sky_faces = np.ascontiguousarray(state.sky_faces.cpu().numpy(), np.float32)
    ch = _chart_host(state.light_max_distance)
    offsets = np.ascontiguousarray(ch["offsets"], np.int8)
    faces_in = np.ascontiguousarray(ch["faces_in"], np.uint8)
    kinds = np.ascontiguousarray(ch["kinds"], np.uint8)
    cosines = np.ascontiguousarray(ch["cosines"], np.float32)
    stats = np.zeros(2, np.int64)
    out_light = np.zeros((sx, sy, sz, 4), np.uint8) if return_light else None
    secs = lib.ref_relight_run(
        sx, sy, sz, _cp(contents, ctypes.c_int32), visible.shape[0],
        _cp(visible, ctypes.c_uint8), _cp(opaque_all, ctypes.c_uint8),
        _cp(face_rows, ctypes.c_float), _cp(emission, ctypes.c_float),
        _cp(mean_alpha, ctypes.c_float), _cp(sky_faces, ctypes.c_float),
        int(ch["n_rays"]), int(ch["max_steps"]),
        _cp(offsets, ctypes.c_int8), _cp(faces_in, ctypes.c_uint8),
        _cp(kinds, ctypes.c_uint8), _cp(cosines, ctypes.c_float),
        _cp(stats, ctypes.c_int64),
        _cp(out_light, ctypes.c_uint8) if return_light else None,
    )
    if return_light:
        return float(secs), int(stats[0]), out_light
    return float(secs), int(stats[0])


def ref_relight_light_bench():
    """The reference procedure on the reference's own benchmark scene
    (content/testing.rs light_bench_space 54x16x54; benches light.rs:27-67
    "eval/full"). The procedure runs on the host, so the scene is
    snapshotted on the CPU. Returns (seconds, n_cubes)."""
    from ..content.testing import light_bench_space

    state = light_bench_space().snapshot(device="cpu")
    secs, _ = ref_relight_state(state)
    return secs, int(state.contents.numel())
