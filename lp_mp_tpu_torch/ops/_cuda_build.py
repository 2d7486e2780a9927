"""Build ``lp_mp_tpu_torch/csrc/*.cu`` with nvcc at first use and load it.

The sources have a plain C interface (no PyTorch headers), so one nvcc call
takes seconds.  The shared library lands in ``build/lp_mp_tpu_torch/`` at
the root of the checkout, named by a hash of the sources and flags, and is
loaded with ``ctypes``.  A missing nvcc, a failed compile or a failed load
raises with the compiler's output in the message: nothing falls back.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "lp_mp_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PP, _LLP = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    # 7 input pointers, 5 output pointers, L, H, W, ..., device, stream
    "lpmp_grid_phase_update": [_P] * 12 + [_I, _I, _I, _I, _I, _F, _I, _P],
    # the same with the labels' pointer after the outputs
    "lpmp_grid_round_phase_update": [_P] * 13 + [_I, _I, _I, _I, _I, _F, _I, _P],
    # 7 input pointers, labels, work, n_work, L, H, W, device, stream
    "lpmp_grid_primal_cost": [_P] * 9 + [_I, _I, _I, _I, _I, _P],
    # ... n_rounds, tile_rows, tile_cols, device, stream
    "lpmp_grid_round_update": [_P] * 12 + [_I, _I, _I, _I, _I, _I, _I, _P],
    # array of 26 pointers (21 inputs, 5 outputs), array of 14 slab label
    # strides, L, n, W, row0, H, ..., device, stream
    "lpmp_grid_phase_update_sharded": [_PP, _LLP, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "lpmp_grid_round_update_sharded": [_PP, _LLP] + [_I] * 9 + [_P],
    # L, n_rounds, tile_rows, tile_cols, out[6]
    "lpmp_grid_round_tile": [_I, _I, _I, _I, _LLP],
}


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float     # wall time of the nvcc call; 0.0 when reused
    log: str           # nvcc's output (ptxas register and shared-memory lines)


_LIB: "ctypes.CDLL | None" = None


def sources() -> list:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in /usr/local/cuda/bin: "
                       "the CUDA grid kernels cannot be built")


def build(force: bool = False) -> Build:
    """Compile the sources unless a library of the same hash exists."""
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    so = BUILD_DIR / f"lpmp_grid_{h.hexdigest()[:16]}.so"
    log = so.with_suffix(".log")
    if so.exists() and not force:
        return Build(so, 0.0, log.read_text() if log.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *(str(p) for p in srcs if p.suffix == ".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    text = proc.stdout + proc.stderr
    log.write_text(text)
    os.replace(tmp, so)    # atomic: a concurrent process never loads a partial file
    return Build(so, seconds, text)


def load(path: Path) -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"loading the grid kernel library {path} failed: {e}") from e
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.lpmp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lpmp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        _LIB = load(build().path)
    return _LIB
