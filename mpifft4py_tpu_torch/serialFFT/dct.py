"""Discrete cosine transforms (types 1–4) from even-extension FFTs.

Counterpart of ``mpifft4py_tpu/serialFFT/dct.py``: the same constructions
over ``torch.fft`` (on the card cuFFT: no hand-written kernel, as the
reference's are ``jnp.fft``).  Conventions match ``scipy.fftpack.dct``/
``idct`` with ``norm=None``:

* type 2 (default):  ``y[k] = 2 Σ_n x[n] cos(πk(2n+1)/(2N))``
* type 3:            ``y[k] = x[0] + 2 Σ_{n≥1} x[n] cos(πn(2k+1)/(2N))``
* type 1:            ``y[k] = x[0] + (-1)^k x[N-1] + 2 Σ_{0<n<N-1} x[n] cos(πnk/(N-1))``
* type 4:            ``y[k] = 2 Σ_n x[n] cos(π(2k+1)(2n+1)/(4N))``

``idct(dct(x, type=2), type=2) == 2N·x`` (scipy.fftpack's unnormalised
pairing).  The phases are complex128, as the reference's are with x64 on;
the result takes the input's dtype.
"""

from __future__ import annotations

import math

import torch

__all__ = ["dct", "idct"]


def _along(v, x, axis):
    """The 1-D tensor ``v`` shaped to broadcast along ``axis`` of ``x``."""
    shape = [1] * x.ndim
    shape[axis] = v.shape[0]
    return v.reshape(shape)


def _k(x, axis):
    return torch.arange(x.shape[axis], dtype=torch.float64, device=x.device)


def _dct2(x, axis):
    n = x.shape[axis]
    ext = torch.cat([x, torch.flip(x, (axis,))], dim=axis)
    F = torch.fft.fft(ext, dim=axis)
    phase = _along(torch.exp(-1j * math.pi * _k(x, axis) / (2 * n)), x, axis)
    return torch.real(phase * F.narrow(axis, 0, n)).to(x.dtype)


def _dct3(x, axis):
    n = x.shape[axis]
    # c[0] = x[0], c[n>=1] = 2 x[n];  d[n] = c[n] exp(i π n / (2N));
    # y[k] = Re( FFT_{2N}(conj(d ⊕ 0))[k] ),  k = 0..N-1.
    k = _k(x, axis)
    w = _along(torch.where(k == 0, 1.0, 2.0), x, axis)
    phase = _along(torch.exp(1j * math.pi * k / (2 * n)), x, axis)
    d = torch.conj_physical(x * w * phase)
    F = torch.fft.fft(torch.cat([d, torch.zeros_like(d)], dim=axis), dim=axis)
    return torch.real(F.narrow(axis, 0, n)).to(x.dtype)


def _dct4(x, axis):
    n = x.shape[axis]
    # y[k] = 2 Re{ e^{-iπ(2k+1)/(4N)} · FFT_{2N}(x[n] e^{-iπn/(2N)} ⊕ 0)[k] }
    k = _k(x, axis)
    pre = _along(torch.exp(-1j * math.pi * k / (2 * n)), x, axis)
    post = _along(torch.exp(-1j * math.pi * (2 * k + 1) / (4 * n)), x, axis)
    xp = x * pre
    F = torch.fft.fft(torch.cat([xp, torch.zeros_like(xp)], dim=axis),
                      dim=axis)
    return (2 * torch.real(post * F.narrow(axis, 0, n))).to(x.dtype)


def _dct1(x, axis):
    n = x.shape[axis]
    inner = x.index_select(axis, torch.arange(n - 2, 0, -1, device=x.device))
    F = torch.fft.fft(torch.cat([x, inner], dim=axis), dim=axis)
    return torch.real(F.narrow(axis, 0, n)).to(x.dtype)


_DCT = {1: _dct1, 2: _dct2, 3: _dct3, 4: _dct4}
# scipy.fftpack's unnormalised inverses: idct(·,2) is the raw DCT-III,
# idct(·,3) the raw DCT-II, and DCT-I and DCT-IV are their own inverses up
# to 2(N-1) and 2N
_IDCT = {1: _dct1, 2: _dct3, 3: _dct2, 4: _dct4}


def dct(a, b=None, type=2, axis=-1, **kw):
    """scipy.fftpack-compatible DCT.  ``b`` (out param) accepted and
    ignored, as are the reference's other keywords."""
    if type not in _DCT:
        raise NotImplementedError(f"dct type {type} not implemented "
                                  f"(types 1-4 available)")
    return _DCT[type](a, axis % a.ndim)


def idct(a, b=None, type=2, axis=-1, **kw):
    """Inverse DCT with scipy.fftpack's unnormalised pairing: idct(·,2) is
    the raw DCT-III (so ``idct(dct(x)) == 2N·x``), idct(·,3) the raw
    DCT-II."""
    if type not in _IDCT:
        raise NotImplementedError(f"idct type {type} not implemented")
    return _IDCT[type](a, axis % a.ndim)
