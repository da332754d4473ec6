"""Spectral-space padding/truncation and wavenumber helpers.

Port of ``mpifft4py_tpu/utils/spectral.py`` (``regrid`` is not ported yet).
Nyquist handling is the reference's: padding a full axis splits the N-grid
Nyquist coefficient between ±N/2 and truncation sums it back; on the half
(rfft) axis it is halved on padding and doubled on truncation.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "pad_full_axis", "trunc_full_axis", "pad_half_axis", "trunc_half_axis",
    "flip_conj_plane", "wavenumbers_full", "wavenumbers_half",
    "dealias_cutoffs",
]


def _slc(ndim: int, axis: int, start, stop) -> Tuple[slice, ...]:
    s = [slice(None)] * ndim
    s[axis] = slice(start, stop)
    return tuple(s)


def _zeros_like_axis(x, axis: int, size: int):
    shape = list(x.shape)
    shape[axis] = size
    return torch.zeros(shape, dtype=x.dtype, device=x.device)


def pad_full_axis(x, axis: int, M: int):
    """Zero-pad a full (fft-layout) spectral axis from N to M, splitting Nyquist."""
    N = x.shape[axis]
    if M == N:
        return x
    if N % 2 or M < N:
        raise ValueError(f"pad_full_axis: need even N <= M, got N={N}, M={M}")
    h = N // 2
    nd = x.ndim
    ny = x[_slc(nd, axis, h, h + 1)] * 0.5
    return torch.cat([x[_slc(nd, axis, 0, h)], ny,
                      _zeros_like_axis(x, axis, M - N - 1), ny,
                      x[_slc(nd, axis, h + 1, N)]], dim=axis)


def trunc_full_axis(x, axis: int, N: int):
    """Truncate a full spectral axis from M back to N, summing the split Nyquist."""
    M = x.shape[axis]
    if M == N:
        return x
    h = N // 2
    nd = x.ndim
    ny = x[_slc(nd, axis, h, h + 1)] + x[_slc(nd, axis, M - h, M - h + 1)]
    return torch.cat([x[_slc(nd, axis, 0, h)], ny,
                      x[_slc(nd, axis, M - h + 1, M)]], dim=axis)


def pad_half_axis(x, axis: int, Mf: int, Nf: int | None = None):
    """Zero-pad a half (rfft-layout) spectral axis from Nf to Mf, halving
    Nyquist; modes at index >= ``Nf`` (alignment padding) are dropped."""
    nd = x.ndim
    if Nf is None:
        Nf = x.shape[axis]
    if Mf == Nf and Nf == x.shape[axis]:
        return x
    ny = x[_slc(nd, axis, Nf - 1, Nf)] * 0.5
    return torch.cat([x[_slc(nd, axis, 0, Nf - 1)], ny,
                      _zeros_like_axis(x, axis, Mf - Nf)], dim=axis)


def trunc_half_axis(x, axis: int, Nf: int):
    """Truncate a half spectral axis from Mf back to Nf, doubling Nyquist."""
    nd = x.ndim
    if x.shape[axis] == Nf:
        return x
    ny = x[_slc(nd, axis, Nf - 1, Nf)] * 2.0
    return torch.cat([x[_slc(nd, axis, 0, Nf - 1)], ny], dim=axis)


def flip_conj_plane(q, axes):
    """conj(Q(−k)) over full fft-layout ``axes`` (index j → (n−j) mod n)."""
    axes = tuple(axes)
    return torch.conj_physical(
        torch.roll(torch.flip(q, axes), (1,) * len(axes), axes))


# ---- wavenumbers (host numpy, as in the reference) ---------------------------

def wavenumbers_full(n: int, dtype=np.float64) -> np.ndarray:
    """Integer wavenumbers in fft layout: [0..n/2-1, -n/2..-1]."""
    return np.fft.fftfreq(n, 1.0 / n).astype(dtype)


def wavenumbers_half(nf: int, dtype=np.float64) -> np.ndarray:
    """Integer wavenumbers in rfft layout: [0..nf-1]."""
    return np.arange(nf, dtype=dtype)


def dealias_cutoffs(N: Sequence[int]) -> np.ndarray:
    """2/3-rule cutoffs per axis: keep |k_i| < (2/3)·(N_i/2)."""
    return np.array([(2.0 / 3.0) * (n // 2) for n in N])
