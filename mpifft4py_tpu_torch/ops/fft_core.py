"""Per-axis transforms over ``torch.fft`` (cuFFT on the card).

Port of the dispatch layer of ``mpifft4py_tpu/ops/fft_core.py``, whose
default route is ``jnp.fft``.  It serves ``precision="double"`` and the
shapes outside the hand-written kernels' envelope, as ``jnp.fft`` does in
the reference.  It is never the port of a kernel.
"""

from __future__ import annotations

import torch

__all__ = ["fft", "ifft", "rfft", "irfft", "fft2", "ifft2", "rfft2", "irfft2"]


def fft(x, axis=-1):
    return torch.fft.fft(x, dim=axis)


def ifft(x, axis=-1):
    return torch.fft.ifft(x, dim=axis)


def rfft(x, axis=-1):
    return torch.fft.rfft(x, dim=axis)


def irfft(x, axis=-1, n=None):
    nn = n if n is not None else 2 * (x.shape[axis % x.ndim] - 1)
    return torch.fft.irfft(x, n=nn, dim=axis)


def fft2(x, axes=(-2, -1)):
    return torch.fft.fft2(x, dim=axes)


def ifft2(x, axes=(-2, -1)):
    return torch.fft.ifft2(x, dim=axes)


def rfft2(x, axes=(-2, -1)):
    return fft(rfft(x, axis=axes[1]), axis=axes[0])


def irfft2(x, s, axes=(-2, -1)):
    return irfft(ifft(x, axis=axes[0]), axis=axes[1], n=s[1])
