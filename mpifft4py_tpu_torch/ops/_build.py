"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

The sources under ``ops/csrc/`` expose a plain C interface (no PyTorch
headers), so one ``nvcc`` per source, all started together, builds them
in seconds.  The shared library
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

__all__ = ["load", "build_dir", "last_build_seconds", "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fft_axis.cu", "packed_rfft.cu", "curl_ifft_x.cu",
           "cross_rfft_z.cu", "fft_x_epilogue.cu", "planar_rfft.cu",
           "fft_last.cu")
HEADERS = ("fft_block.cuh", "packed_z.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = (*ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # xr, xi, yr, yi, tw, pre, n, post, inverse, stream
    "fft_axis_launch": (_P, _P, _P, _P, _P, _L, _I, _L, _I, _P),
    # x, yr, yi, tw_h, tw_n, rows, n, stream
    "packed_rfft_launch": (_P, _P, _P, _P, _P, _L, _I, _P),
    # xr, xi, y, tw_h, tw_n, rows, n, stream
    "packed_irfft_launch": (_P, _P, _P, _P, _P, _L, _I, _P),
    # ur, ui, k0, k1, k2, yr, yi, tw, n, n1, h, with_state, biot_savart,
    # stream
    "curl_ifft_x_launch": (_P,) * 8 + (_I,) * 5 + (_P,),
    # a, b, c, d, yr, yi, tw_h, tw_n, rows, n, op, stream
    "cross_rfft_z_launch": (_P,) * 8 + (_L, _I, _I, _P),
    # fr, fi, sr, si, tr, ti, k0, k1, k2, m0, m1, m2, yr, yi, tw, n, n1, h,
    # visc, mode, ri, stream
    "fft_x_epilogue_launch": (_P,) * 15 + (_I, _I, _I, ctypes.c_float, _I,
                                          ctypes.c_float, _P),
    # x, yr, yi, tw_h, tw_n, rows, n, nf, dbl, scale, stream
    "planar_rfft_launch": (_P,) * 5 + (_L, _I, _I, _I, ctypes.c_float, _P),
    # xr, xi, y, tw_h, tw_n, rows, n, nf_in, scale, stream
    "planar_irfft_launch": (_P,) * 5 + (_L, _I, _I, ctypes.c_float, _P),
    # xr, xi, yr, yi, tw, rows, n, inverse, scale, stream
    "fft_last_launch": (_P,) * 5 + (_L, _I, _I, ctypes.c_float, _P),
}

_lib = None
last_build_seconds = None   # wall time of the nvcc calls; None if none ran


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
    """One nvcc per source, all started together, then one link; ptxas's
    register and spill report goes beside the library."""
    global last_build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(tmp, src + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *FLAGS, "-c", "-I", str(CSRC), "-o", obj,
                 str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        failed = [f"{src}:\n{log}" for src, p, log in zip(SOURCES, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{proc.stderr}")
        Path(str(out) + ".ptxas.txt").write_text("".join(logs))
        os.replace(lib, out)
    last_build_seconds = time.perf_counter() - t0


def ptxas_report() -> str:
    """ptxas's per-kernel registers, shared memory and spills from the
    build of the loaded library."""
    return Path(str(_lib_path()) + ".ptxas.txt").read_text()


def _lib_path() -> Path:
    return build_dir() / f"libmpifft4py_torch_{_digest()}.so"


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use and cached per process."""
    global _lib
    if _lib is None:
        path = _lib_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
