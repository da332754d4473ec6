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
    "dealias_cutoffs", "factored_wavenumbers", "packed_dealias_masks",
    "packed_hermitian_weights", "ksq",
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


# ---- factored 1-D wavenumbers of the solvers' spectral layouts ---------------
#
# The r2c layout's last axis holds k2 = 0..N2/2 (n2 = N2/2+1 columns; the
# pencil's n2 = Nfp, the lanes >= N2/2+1 structural zeros); the packed
# layout's holds k2 = 0..N2/2−1 (n2 = N2/2, no Nyquist column: the
# z-Nyquist rides the plane-0 column and a purified pair holds none).
# ``slices`` is a transform's ``local_spectral_slices(layout)``: this
# rank's block of each axis (the whole axes when None).

def _blocks(ks, slices):
    slices = slices or (slice(None),) * 3
    return tuple(torch.from_numpy(np.ascontiguousarray(k[s]))
                 for k, s in zip(ks, slices))


def factored_wavenumbers(N, L, n2: int, dtype=torch.float32, device="cpu",
                         slices=None):
    """1-D wavenumbers (k0, k1, k2) on ``device``: k0, k1 in fft layout,
    k2 = 0..n2−1, each scaled by 2π/L in ``dtype`` (``L=None``: the integer
    wavenumbers), each cut to ``slices``.  A float64 k against a complex64
    state would promote the state to complex128, so the dtype follows the
    solver's precision."""
    ft = np.float32 if dtype == torch.float32 else np.float64
    s = (np.ones(3) if L is None else 2 * np.pi / np.asarray(L)).astype(ft)
    ks = (wavenumbers_full(int(N[0]), ft) * s[0],
          wavenumbers_full(int(N[1]), ft) * s[1],
          wavenumbers_half(int(n2), ft) * s[2])
    return tuple(k.to(device) for k in _blocks(ks, slices))


def packed_dealias_masks(N, device="cpu", slices=None):
    """1-D 2/3-rule masks (m0, m1, m2) of the packed layout, bool, each
    cut to ``slices``."""
    ks = (wavenumbers_full(int(N[0])), wavenumbers_full(int(N[1])),
          wavenumbers_half(int(N[2]) // 2))
    ms = [np.abs(k) < c for k, c in zip(ks, dealias_cutoffs(N))]
    return tuple(m.to(device) for m in _blocks(ms, slices))


def packed_hermitian_weights(N, device="cpu") -> torch.Tensor:
    """Weights over the packed layout's k2 axis: 1 on k2 = 0, 2 elsewhere
    (a purified packed pair has no Nyquist column), float32."""
    w = torch.full((int(N[2]) // 2,), 2.0, dtype=torch.float32, device=device)
    w[0] = 1.0
    return w


def ksq(k0, k1, k2) -> torch.Tensor:
    """|K|² broadcast from the 1-D factors to (len k0, len k1, len k2)."""
    return (k0[:, None, None] ** 2 + k1[None, :, None] ** 2
            + k2[None, None, :] ** 2)
