"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

The sources under ``ops/csrc/`` expose a plain C interface (no PyTorch
headers), so one ``nvcc`` call builds them in seconds.  The shared library
lands in ``build/torch_kernels/`` beside the package (listed in
``.gitignore``), named by a hash of the sources and the flags, at first use:
a second call in the same checkout finds it and only loads it.  Nothing here
runs at import time; the CPU tests import this module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["load", "build_dir", "last_build_seconds"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fft_axis.cu", "packed_rfft.cu")
HEADERS = ("fft_block.cuh",)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_SIGNATURES = {
    # xr, xi, yr, yi, tw, pre, n, post, inverse, stream
    "fft_axis_launch": (_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_longlong, ctypes.c_int, _P),
    # x, yr, yi, tw_h, tw_n, rows, n, stream
    "packed_rfft_launch": (_P, _P, _P, _P, _P, ctypes.c_longlong,
                           ctypes.c_int, _P),
    # xr, xi, y, tw_h, tw_n, rows, n, stream
    "packed_irfft_launch": (_P, _P, _P, _P, _P, ctypes.c_longlong,
                            ctypes.c_int, _P),
}

_lib = None
last_build_seconds = None   # wall time of the nvcc call; None if none ran


def build_dir() -> Path:
    """``build/torch_kernels`` in the directory that holds the package."""
    return CSRC.parents[2] / "build" / "torch_kernels"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built on the machine with the card")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    global last_build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *FLAGS, "-I", str(CSRC), "-o", tmp,
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use and cached per process."""
    global _lib
    if _lib is None:
        path = build_dir() / f"libmpifft4py_torch_{_digest()}.so"
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
