"""ctypes loader for the native host library (csrc/lpmp_host.cpp).

Copy of ``lp_mp_tpu/native.py`` for the port (importing that module would
import JAX).  The native routines (min-cost flow, GAEC, maxflow, BFS path,
levelize, distance-2 colouring) mirror the reference's vendored C++
(lib/MinCost, lib/max_flow.hxx, union_find.hxx, graph.hxx).  The library is
compiled on demand with g++ from the repository's ``csrc/lpmp_host.cpp``
into a cache directory of its own (``LPMP_TORCH_NATIVE_CACHE``, default
``$TMPDIR/lp_mp_tpu_torch_native``), so the two packages never race on one
``.so``; the build goes to a per-process temporary name and is renamed into
place.  Every caller has a pure-Python fallback, so a missing toolchain only
costs host-side speed.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "..", "csrc", "lpmp_host.cpp")


def _build(src: str, out: str) -> bool:
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)
    return True


def get_lib():
    """Load (building if necessary) the native library, or None."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    src = os.path.abspath(_SRC)
    if not os.path.exists(src):
        return None
    cache = os.environ.get("LPMP_TORCH_NATIVE_CACHE",
                           os.path.join(tempfile.gettempdir(), "lp_mp_tpu_torch_native"))
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, "liblpmp_host.so")
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        if not _build(src, so):
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.lpmp_mcf_solve.restype = ctypes.c_double
    lib.lpmp_mcf_solve.argtypes = [ctypes.c_int, ctypes.c_int, i64p, i64p,
                                   f64p, f64p, f64p, f64p, f64p]
    lib.lpmp_gaec.restype = None
    lib.lpmp_gaec.argtypes = [ctypes.c_int, ctypes.c_int, i64p, i64p, f64p, i64p]
    lib.lpmp_maxflow.restype = ctypes.c_double
    lib.lpmp_maxflow.argtypes = [ctypes.c_int, ctypes.c_int, i64p, i64p,
                                 f64p, f64p, ctypes.c_int, ctypes.c_int, i64p]
    lib.lpmp_bfs_path.restype = ctypes.c_int
    lib.lpmp_bfs_path.argtypes = [ctypes.c_int, ctypes.c_int, i64p, i64p, f64p,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                  i64p, ctypes.c_int]
    lib.lpmp_bfs_paths.restype = ctypes.c_int64
    lib.lpmp_bfs_paths.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i64p,
                                   f64p, ctypes.c_int64, i64p, i64p,
                                   ctypes.c_double, ctypes.c_int64, i64p,
                                   i64p, f64p]
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.lpmp_levelize.restype = ctypes.c_int64
    lib.lpmp_levelize.argtypes = [ctypes.c_int64, i64p, ctypes.c_int64,
                                  i64p, i64p, u8p, i64p]
    lib.lpmp_color2.restype = ctypes.c_int64
    lib.lpmp_color2.argtypes = [ctypes.c_int64, i64p, i64p, u8p, i64p]
    _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# typed wrappers (None-safe: callers fall back to Python when get_lib() is None)
# ---------------------------------------------------------------------------

def mcf_solve(n: int, tails, heads, lowers, uppers, costs, excess):
    """Returns (objective, flows) or None if native lib unavailable;
    raises RuntimeError on infeasible instances."""
    lib = get_lib()
    if lib is None:
        return None
    tails = np.ascontiguousarray(tails, dtype=np.int64)
    heads = np.ascontiguousarray(heads, dtype=np.int64)
    lowers = np.ascontiguousarray(lowers, dtype=np.float64)
    uppers = np.ascontiguousarray(uppers, dtype=np.float64)
    costs = np.ascontiguousarray(costs, dtype=np.float64)
    excess = np.ascontiguousarray(excess, dtype=np.float64)
    m = len(tails)
    flows = np.zeros(m, dtype=np.float64)
    obj = lib.lpmp_mcf_solve(n, m, tails, heads, lowers, uppers, costs,
                             excess, flows)
    if np.isnan(obj):
        raise RuntimeError("min-cost flow infeasible: unroutable excess")
    return float(obj), flows


def gaec(n: int, us, vs, ws):
    """Greedy additive edge contraction; returns contiguous labels [n]
    or None if native lib unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    us = np.ascontiguousarray(us, dtype=np.int64)
    vs = np.ascontiguousarray(vs, dtype=np.int64)
    ws = np.ascontiguousarray(ws, dtype=np.float64)
    labels = np.zeros(n, dtype=np.int64)
    lib.lpmp_gaec(n, len(us), us, vs, ws, labels)
    return labels


def maxflow(n: int, us, vs, cap_uv, cap_vu, s: int, t: int):
    """Returns (flow value, source-side mask [n]) or None."""
    lib = get_lib()
    if lib is None:
        return None
    us = np.ascontiguousarray(us, dtype=np.int64)
    vs = np.ascontiguousarray(vs, dtype=np.int64)
    cap_uv = np.ascontiguousarray(cap_uv, dtype=np.float64)
    cap_vu = np.ascontiguousarray(cap_vu, dtype=np.float64)
    side = np.zeros(n, dtype=np.int64)
    f = lib.lpmp_maxflow(n, len(us), us, vs, cap_uv, cap_vu, s, t, side)
    return float(f), side.astype(bool)


def bfs_path(n: int, us, vs, ws, src: int, dst: int, threshold: float):
    """Path src->dst over edges with weight > threshold, or None (no native
    lib) or [] (no path)."""
    lib = get_lib()
    if lib is None:
        return None
    us = np.ascontiguousarray(us, dtype=np.int64)
    vs = np.ascontiguousarray(vs, dtype=np.int64)
    ws = np.ascontiguousarray(ws, dtype=np.float64)
    cap = n + 1
    out = np.zeros(cap, dtype=np.int64)
    r = lib.lpmp_bfs_path(n, len(us), us, vs, ws, src, dst, threshold, out, cap)
    if r == 0:
        return []
    assert r > 0
    return [int(x) for x in out[:r]]


def bfs_paths(n: int, us, vs, ws, srcs, dsts, threshold: float,
              max_len: int = 256):
    """Batched BFS path queries over one thresholded graph (adjacency built
    once).  Returns (paths: list of node lists ([] = none/too long),
    bottlenecks [k]) or None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    us = np.ascontiguousarray(us, dtype=np.int64)
    vs = np.ascontiguousarray(vs, dtype=np.int64)
    ws = np.ascontiguousarray(ws, dtype=np.float64)
    srcs = np.ascontiguousarray(srcs, dtype=np.int64)
    dsts = np.ascontiguousarray(dsts, dtype=np.int64)
    k = len(srcs)
    out_paths = np.zeros(k * max_len, dtype=np.int64)
    out_lens = np.zeros(k, dtype=np.int64)
    out_bn = np.zeros(k, dtype=np.float64)
    lib.lpmp_bfs_paths(n, len(us), us, vs, ws, k, srcs, dsts, threshold,
                       max_len, out_paths, out_lens, out_bn)
    paths = [out_paths[q * max_len: q * max_len + out_lens[q]].tolist()
             for q in range(k)]
    return paths, out_bn


def levelize_csr(order, indptr, indices, updated):
    """Phase id per factor (-1 = unscheduled) + #phases, or None (no lib)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(updated)
    order = np.ascontiguousarray(order, dtype=np.int64)
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    upd = np.ascontiguousarray(updated, dtype=np.uint8)
    out = np.full(n, -1, dtype=np.int64)
    n_phases = lib.lpmp_levelize(n, order, len(order), indptr, indices, upd, out)
    return out, int(n_phases)


def color2_csr(indptr, indices, updated):
    """Distance-2 greedy colors per updated factor (-1 otherwise), or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(updated)
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    upd = np.ascontiguousarray(updated, dtype=np.uint8)
    out = np.full(n, -1, dtype=np.int64)
    lib.lpmp_color2(n, indptr, indices, upd, out)
    return out
