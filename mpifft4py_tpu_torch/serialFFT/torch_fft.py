"""The serial FFT tier over ``torch.fft``.

Counterpart of ``mpifft4py_tpu/serialFFT/xla_fft.py``, which wraps
``jnp.fft`` with the reference mpiFFT4py's call signatures: every function
keeps the out argument ``b`` (accepted and ignored: PyTorch allocates the
result) and accepts and ignores ``threads=`` and ``planner_effort=``; any
other keyword raises ``TypeError``.  Normalisation follows numpy: the
forward unscaled, the inverse scaled by 1/N.

``rfftn``/``irfftn`` route as the reference's do: a 3-D float32 input
(complex64 for the inverse, with ``s`` of length 3 and ``s[2] // 2 + 1``
columns) transformed over axes None or (0, 1, 2), whose shape is in the
kernels' envelope (``ops.fft3d.supported_r2c_grid``, the predicate of
``slab.R2C._kernel3d_ok``), takes ``ops.fft3d.rfft3d``/
``irfft3d``: on the card the hand-written kernels, on the CPU their plain
twins through the same glue.  Everything else takes ``torch.fft``, as the
reference's other functions take ``jnp.fft``.
"""

from __future__ import annotations

import torch

from ..ops import fft3d as p3
from .dct import dct, idct  # re-exported; part of the L1 surface

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "dct", "idct",
]


def _ignore(kw):
    # the reference's keywords with no meaning here: threads, planner_effort
    kw.pop("threads", None)
    kw.pop("planner_effort", None)
    if kw:
        raise TypeError(f"unexpected kwargs: {sorted(kw)}")


# ---- complex-to-complex -----------------------------------------------------

def fft(a, b=None, axis=-1, **kw):
    _ignore(kw)
    return torch.fft.fft(a, dim=axis)


def ifft(a, b=None, axis=-1, **kw):
    _ignore(kw)
    return torch.fft.ifft(a, dim=axis)


def fft2(a, b=None, axes=(-2, -1), **kw):
    _ignore(kw)
    return torch.fft.fft2(a, dim=axes)


def ifft2(a, b=None, axes=(-2, -1), **kw):
    _ignore(kw)
    return torch.fft.ifft2(a, dim=axes)


def fftn(a, b=None, axes=None, **kw):
    _ignore(kw)
    return torch.fft.fftn(a, dim=axes)


def ifftn(a, b=None, axes=None, **kw):
    _ignore(kw)
    return torch.fft.ifftn(a, dim=axes)


# ---- real-to-complex / complex-to-real -------------------------------------

def rfft(a, b=None, axis=-1, **kw):
    _ignore(kw)
    return torch.fft.rfft(a, dim=axis)


def irfft(a, b=None, axis=-1, n=None, **kw):
    _ignore(kw)
    return torch.fft.irfft(a, n=n, dim=axis)


def rfft2(a, b=None, axes=(-2, -1), **kw):
    _ignore(kw)
    return torch.fft.rfft2(a, dim=axes)


def irfft2(a, b=None, axes=(-2, -1), s=None, **kw):
    _ignore(kw)
    return torch.fft.irfft2(a, s=s, dim=axes)


def rfftn(a, b=None, axes=None, **kw):
    _ignore(kw)
    if (axes in (None, (0, 1, 2)) and a.dtype == torch.float32
            and p3.supported_r2c_grid(a.shape)):
        return p3.rfft3d(a.contiguous())
    return torch.fft.rfftn(a, dim=axes)


def irfftn(a, b=None, axes=None, s=None, **kw):
    _ignore(kw)
    if (axes in (None, (0, 1, 2)) and a.dtype == torch.complex64
            and s is not None and p3.supported_r2c_grid(s)
            and tuple(a.shape) == (s[0], s[1], s[2] // 2 + 1)):
        return p3.irfft3d(a, tuple(s))
    return torch.fft.irfftn(a, s=s, dim=axes)
