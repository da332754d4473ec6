"""Dense per-axis FFTs of complex64/float32 tensors (rows 19–22).

Port of ``mpifft4py_tpu/ops/pallas_fft.py``: the same functions and numpy
conventions (the forward unscaled, the inverse scaled by 1/n):

* ``fft_axis(x, axis, inverse=False)``: c2c DFT of a complex64 tensor along
  ``axis``, viewed as (pre, n, post).  A non-last axis launches the
  complex64 instance of ``csrc/fft_axis.cu`` (row 19, ``_fft_axis_pallas``);
  the last axis (post == 1, the reference's ``_fft_last_pallas`` branch)
  the complex64 instance of ``csrc/fft_last.cu`` (row 20).
* ``rfft_last(x)``: numpy ``rfft`` along the last axis, float32 (…, n) to
  complex64 (…, n/2 + 1): the complex64 instance of
  ``csrc/planar_rfft.cu``'s half-length r2c at even n (row 21).
* ``irfft_last(x, n)``: numpy ``irfft`` from complex64 (…, n/2 + 1) to
  float32 (…, n): the complex64 instance of its c2r at even n (row 22).
  The reference's ``irfft_last`` weights its last column as a Nyquist
  column at every n, so at odd n it is not numpy's ``irfft``; this one is.

Odd n in rows 21–22 takes the full-length kernels of ``planar_rfft.cu`` (one
n-point c2c of each row), since the half-length trick needs even n.  Each
call is one launch, with no split into or merge from a planar pair.

The envelope is what the kernels' plans serve (``csrc/fft_block.cuh``):
c2c 2 <= n <= 1024; r2c/c2r even n in 4..2048 or odd n in 3..1023.
Outside it the functions raise, as ``fft3d``'s do (the reference's VMEM
tiling, ``_pick_tq`` and the 256/128-row tiles, does not carry over).

Every function has a plain twin (``*_ref``) over ``torch.fft``.  A wrapper
runs the twin for CPU tensors only; for CUDA tensors it launches the kernel
or raises.  Launches count in ``fft3d.LAUNCHES`` under ``dense_fft_axis``,
``dense_fft_last``, ``dense_rfft_last`` and ``dense_irfft_last``.
"""

from __future__ import annotations

import math

import torch

from .fft3d import _launch, _twiddles

__all__ = ["c2c_ok", "r2c_ok", "fft_axis", "rfft_last", "irfft_last",
           "fft_axis_ref", "rfft_last_ref", "irfft_last_ref"]


def c2c_ok(n: int) -> bool:
    """The c2c kernels' plans serve 2 <= n <= 1024."""
    return 2 <= n <= 1024


def r2c_ok(n: int) -> bool:
    """The r2c/c2r kernels serve even n in 4..2048 (a half-length plan of
    n/2 <= 1024) and odd n in 3..1023 (a full-length plan)."""
    return 4 <= n <= 2048 if n % 2 == 0 else 3 <= n <= 1023


def _check(x, dtype) -> bool:
    """Validates a dense function's input; True when it lies on the CPU
    (the plain twin runs), False on CUDA (the kernel launches)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the tensor must be on the CPU or a CUDA device, "
                         f"got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the dense functions take contiguous tensors")
    return x.device.type == "cpu"


# -- c2c along any axis (rows 19-20) ------------------------------------------

def fft_axis_ref(x, axis: int, inverse: bool = False):
    fn = torch.fft.ifft if inverse else torch.fft.fft
    return fn(x, dim=axis).contiguous()


def fft_axis(x, axis: int, inverse: bool = False):
    """c2c DFT along ``axis`` of a complex64 tensor; the forward is
    unscaled, the inverse scales by 1/n."""
    on_cpu = _check(x, torch.complex64)
    axis = axis % x.ndim
    n = int(x.shape[axis])
    if not c2c_ok(n):
        raise ValueError(f"fft_axis: n={n} outside the kernel envelope")
    if on_cpu:
        return fft_axis_ref(x, axis, inverse)
    pre = math.prod(x.shape[:axis])
    post = math.prod(x.shape[axis + 1:])
    y = torch.empty_like(x)
    tw = _twiddles(n, n, 1 if inverse else -1, x.device)
    if post == 1:
        _launch("dense_fft_last", "fft_last_c64_launch", x.data_ptr(),
                y.data_ptr(), tw.data_ptr(), pre, n, int(inverse),
                device=x.device)
    else:
        _launch("dense_fft_axis", "fft_axis_c64_launch", x.data_ptr(),
                y.data_ptr(), tw.data_ptr(), pre, n, post, int(inverse),
                device=x.device)
    return y


# -- r2c / c2r along the last axis (rows 21-22) -------------------------------

def rfft_last_ref(x):
    return torch.fft.rfft(x, dim=-1).contiguous()


def rfft_last(x):
    """numpy ``rfft`` along the last axis: float32 (…, n) -> complex64
    (…, n/2 + 1)."""
    on_cpu = _check(x, torch.float32)
    n = int(x.shape[-1])
    if not r2c_ok(n):
        raise ValueError(f"rfft_last: n={n} outside the kernel envelope")
    if on_cpu:
        return rfft_last_ref(x)
    y = torch.empty(x.shape[:-1] + (n // 2 + 1,), dtype=torch.complex64,
                    device=x.device)
    rows = x.numel() // n
    if n % 2 == 0:
        h = n // 2
        _launch("dense_rfft_last", "rfft_c64_launch", x.data_ptr(),
                y.data_ptr(), _twiddles(h, h, -1, x.device).data_ptr(),
                _twiddles(n, h, -1, x.device).data_ptr(), rows, n,
                device=x.device)
    else:
        _launch("dense_rfft_last", "rfft_full_c64_launch", x.data_ptr(),
                y.data_ptr(), _twiddles(n, n, -1, x.device).data_ptr(), rows,
                n, device=x.device)
    return y


def irfft_last_ref(x, n: int):
    """numpy's ``irfft``: the imaginary parts of column 0 and (at even n)
    column n/2 are dropped first (cuFFT's c2r, given them, returns
    something else)."""
    x = x.clone()
    x[..., 0].imag = 0
    if n % 2 == 0:
        x[..., n // 2].imag = 0
    return torch.fft.irfft(x, n=n, dim=-1).contiguous()


def irfft_last(x, n: int):
    """numpy ``irfft`` along the last axis: complex64 (…, n/2 + 1) ->
    float32 (…, n), scaled by 1/n; the imaginary parts of column 0 and (at
    even n) column n/2 are ignored, as numpy's are."""
    on_cpu = _check(x, torch.complex64)
    nf = int(x.shape[-1])
    if nf != n // 2 + 1:
        raise ValueError(f"irfft_last: {nf} columns for n={n} (expected "
                         f"{n // 2 + 1})")
    if not r2c_ok(n):
        raise ValueError(f"irfft_last: n={n} outside the kernel envelope")
    if on_cpu:
        return irfft_last_ref(x, n)
    y = torch.empty(x.shape[:-1] + (n,), dtype=torch.float32, device=x.device)
    rows = x.numel() // nf
    if n % 2 == 0:
        h = n // 2
        _launch("dense_irfft_last", "irfft_c64_launch", x.data_ptr(),
                y.data_ptr(), _twiddles(h, h, 1, x.device).data_ptr(),
                _twiddles(n, h, 1, x.device).data_ptr(), rows, n,
                device=x.device)
    else:
        _launch("dense_irfft_last", "irfft_full_c64_launch", x.data_ptr(),
                y.data_ptr(), _twiddles(n, n, 1, x.device).data_ptr(), rows,
                n, device=x.device)
    return y
