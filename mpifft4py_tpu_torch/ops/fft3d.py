"""Planar 3D r2c/c2r FFT pipeline over hand-written CUDA kernels.

Port of ``mpifft4py_tpu/ops/pallas_fft3d.py``: the same functions, names and
packed-Hermitian planar layout.  Kernel functions take and return planar
``(re, im)`` float32 pairs; a packed spectrum sits in h = n/2 columns with
column 0 holding X[0] + i·X[n/2].

Three CUDA kernels (``csrc/``) carry the path:

* ``fft_axis`` (``fft_axis_planar``): c2c along a non-last axis;
* ``packed_rfft_last`` / ``packed_irfft_last`` (``rfft_last_packed`` /
  ``irfft_last_packed``): packed r2c / c2r along the last axis.

``fused_zy_fwd`` / ``fused_zy_bwd`` keep the reference's contracts as one
launch per stage (see the source note in ``csrc/fft_axis.cu``).

Every kernel function has a plain twin (``*_ref``) over ``torch.fft``.  A
wrapper runs the twin for CPU tensors only; for CUDA tensors it launches the
kernel or raises.  ``LAUNCHES`` counts kernel launches by kernel name.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "LAUNCHES", "reset_launches", "supported_c2c", "supported_r2c",
    "fft_axis_planar", "rfft_last_packed", "irfft_last_packed",
    "fused_zy_fwd", "fused_zy_bwd", "rfft3d_packed", "irfft3d_packed",
    "unpack_plane0", "pack_plane0", "unpack_spectrum", "pack_spectrum",
    "purify_plane0", "rfft3d", "irfft3d",
]

LAUNCHES = {"fft_axis": 0, "packed_rfft_last": 0, "packed_irfft_last": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def supported_c2c(n: int) -> bool:
    """n = 2^a·3^b with b <= 1 and 16 <= n <= 1024 (the kernels' plans)."""
    m = n // 3 if n % 3 == 0 else n
    return 16 <= n <= 1024 and m & (m - 1) == 0


def supported_r2c(n: int) -> bool:
    return n % 2 == 0 and supported_c2c(n)


# -- validation and routing ----------------------------------------------------

def _check_float32(*ts) -> bool:
    """Validates a kernel function's tensors; True when they lie on the CPU
    (the plain twin runs), False on CUDA (the kernel launches)."""
    kinds = {t.device.type for t in ts}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"tensors must all be on the CPU or all on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"kernel functions take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel functions take contiguous tensors")
    if ts[0].device.type == "cuda" and len({t.device for t in ts}) != 1:
        raise ValueError("tensors lie on different CUDA devices")
    return ts[0].device.type == "cpu"


def _check_pair(xr, xi) -> None:
    if xr.shape != xi.shape:
        raise ValueError(f"re/im shapes differ: {tuple(xr.shape)} vs "
                         f"{tuple(xi.shape)}")


_TWIDDLES: dict = {}


def _twiddles(m: int, count: int, sign: int, device) -> torch.Tensor:
    """(count, 2) float32 table of exp(sign·2πi·j/m), computed in float64
    on the host and cached per device (the role of ``_dft_cs``)."""
    key = (m, count, sign, str(device))
    t = _TWIDDLES.get(key)
    if t is None:
        ang = sign * 2.0 * np.pi * np.arange(count) / m
        tab = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
        t = _TWIDDLES[key] = torch.from_numpy(tab).to(device)
    return t


def _launch(name: str, fn_name: str, *args, device) -> None:
    from . import _build
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(_build.load(), fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1


# -- c2c along a non-last axis ---------------------------------------------------

def fft_axis_planar_ref(xr, xi, axis: int, inverse: bool = False):
    z = torch.complex(xr, xi)
    y = torch.fft.ifft(z, dim=axis) if inverse else torch.fft.fft(z, dim=axis)
    return y.real.contiguous(), y.imag.contiguous()


def fft_axis_planar(xr, xi, axis: int, inverse: bool = False):
    """c2c DFT along a non-last ``axis`` of planar float32 arrays; the
    inverse includes the 1/n scale."""
    on_cpu = _check_float32(xr, xi)
    _check_pair(xr, xi)
    axis = axis % xr.ndim
    if axis == xr.ndim - 1:
        raise ValueError("last axis: use the packed r2c/c2r kernels")
    n = int(xr.shape[axis])
    if not supported_c2c(n):
        raise ValueError(f"fft_axis_planar: n={n} outside the kernel envelope")
    if on_cpu:
        return fft_axis_planar_ref(xr, xi, axis, inverse)
    pre = math.prod(xr.shape[:axis])
    post = math.prod(xr.shape[axis + 1:])
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    sign = 1 if inverse else -1
    tw = _twiddles(n, n, sign, xr.device)
    _launch("fft_axis", "fft_axis_launch", xr.data_ptr(), xi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), tw.data_ptr(), pre, n, post,
            int(inverse), device=xr.device)
    return yr, yi


# -- packed r2c / c2r along the last axis ------------------------------------------

def rfft_last_packed_ref(x):
    h = x.shape[-1] // 2
    X = torch.fft.rfft(x, dim=-1)
    yr = torch.cat([X.real[..., :1], X.real[..., 1:h]], dim=-1)
    yi = torch.cat([X.real[..., h:h + 1], X.imag[..., 1:h]], dim=-1)
    return yr.contiguous(), yi.contiguous()


def rfft_last_packed(x):
    """real (…, n) -> packed planar (re, im), shape (…, n/2)."""
    on_cpu = _check_float32(x)
    n = int(x.shape[-1])
    if not supported_r2c(n):
        raise ValueError(f"rfft_last_packed: n={n} outside the kernel envelope")
    if on_cpu:
        return rfft_last_packed_ref(x)
    h = n // 2
    shp = x.shape[:-1] + (h,)
    yr = torch.empty(shp, dtype=torch.float32, device=x.device)
    yi = torch.empty_like(yr)
    _launch("packed_rfft_last", "packed_rfft_launch", x.data_ptr(),
            yr.data_ptr(), yi.data_ptr(),
            _twiddles(h, h, -1, x.device).data_ptr(),
            _twiddles(n, h, -1, x.device).data_ptr(),
            x.numel() // n, n, device=x.device)
    return yr, yi


def irfft_last_packed_ref(xr, xi, n: int):
    zero = torch.zeros_like(xr[..., :1])
    X = torch.cat([torch.complex(xr[..., :1], zero),
                   torch.complex(xr[..., 1:], xi[..., 1:]),
                   torch.complex(xi[..., :1], zero)], dim=-1)
    return torch.fft.irfft(X, n=n, dim=-1).contiguous()


def irfft_last_packed(xr, xi, n: int):
    """packed planar (…, n/2) -> real (…, n), scaled by 1/n."""
    on_cpu = _check_float32(xr, xi)
    _check_pair(xr, xi)
    if not supported_r2c(n) or xr.shape[-1] != n // 2:
        raise ValueError(f"irfft_last_packed: n={n} with width "
                         f"{xr.shape[-1]} outside the kernel envelope")
    if on_cpu:
        return irfft_last_packed_ref(xr, xi, n)
    h = n // 2
    y = torch.empty(xr.shape[:-1] + (n,), dtype=torch.float32,
                    device=xr.device)
    _launch("packed_irfft_last", "packed_irfft_launch", xr.data_ptr(),
            xi.data_ptr(), y.data_ptr(),
            _twiddles(h, h, 1, xr.device).data_ptr(),
            _twiddles(n, h, 1, xr.device).data_ptr(),
            xr.numel() // h, n, device=xr.device)
    return y


# -- z + y stages ----------------------------------------------------------------

def fused_zy_fwd_ref(u):
    yr, yi = rfft_last_packed_ref(u)
    return fft_axis_planar_ref(yr, yi, axis=u.ndim - 2)


def fused_zy_fwd(u):
    """real (…, N1, N2) -> packed planar (…, N1, N2/2) with y transformed:
    the packed z r2c, then the y c2c.  Leading dims batch."""
    if u.ndim < 2:
        raise ValueError("fused_zy_fwd needs (…, N1, N2)")
    yr, yi = rfft_last_packed(u)
    return fft_axis_planar(yr, yi, axis=u.ndim - 2)


def fused_zy_bwd_ref(yr, yi, n2: int):
    yr, yi = fft_axis_planar_ref(yr, yi, axis=yr.ndim - 2, inverse=True)
    return irfft_last_packed_ref(yr, yi, n2)


def fused_zy_bwd(yr, yi, n2: int):
    """packed planar (…, N1, n2/2) -> real (…, N1, n2): the y c2c inverse
    (1/N1), then the packed z c2r (1/n2)."""
    if yr.ndim < 2:
        raise ValueError("fused_zy_bwd needs (…, N1, n2/2)")
    yr, yi = fft_axis_planar(yr, yi, axis=yr.ndim - 2, inverse=True)
    return irfft_last_packed(yr, yi, n2)


def rfft3d_packed(u):
    """real (…,N0,N1,N2) -> packed planar spectral (re, im), (…,N0,N1,N2/2).
    Leading dims (e.g. velocity components) batch into every launch."""
    if u.ndim < 3:
        raise ValueError("rfft3d_packed needs (…, N0, N1, N2)")
    yr, yi = fused_zy_fwd(u)
    return fft_axis_planar(yr, yi, axis=u.ndim - 3)


def irfft3d_packed(yr, yi, s):
    if yr.ndim < 3:
        raise ValueError("irfft3d_packed needs (…, N0, N1, N2/2)")
    yr, yi = fft_axis_planar(yr, yi, axis=yr.ndim - 3, inverse=True)
    return fused_zy_bwd(yr, yi, int(s[-1]))


# -- the complex boundary (plain tensor algebra on either device) -----------------

def _flipconj(qr, qi, axes):
    """conj(Q(-k)) with wraparound along ``axes``."""
    axes = tuple(axes)
    shifts = (1,) * len(axes)
    fr = torch.roll(torch.flip(qr, axes), shifts, axes)
    fi = torch.roll(torch.flip(qi, axes), shifts, axes)
    return fr, -fi


def unpack_plane0(yr, yi, axes=(0, 1)):
    """Split packed plane 0 into the k=0 and k=Nyquist planes (complex, the
    packed axis removed); ``axes`` are the transformed full axes."""
    qr, qi = yr[..., 0], yi[..., 0]
    cr, ci = _flipconj(qr, qi, axes)
    p0 = torch.complex(0.5 * (qr + cr), 0.5 * (qi + ci))
    pny = torch.complex(0.5 * (qi - ci), -0.5 * (qr - cr))  # (Q−conjQ̃)/(2i)
    return p0, pny


def pack_plane0(p0, pny):
    """Inverse of unpack: packed plane 0 = p0 + i·pny."""
    return p0.real - pny.imag, p0.imag + pny.real


def unpack_spectrum(yr, yi):
    """packed planar (…,N0,N1,h) -> complex (…,N0,N1,h+1)."""
    p0, pny = unpack_plane0(yr, yi, axes=(yr.ndim - 3, yr.ndim - 2))
    body = torch.complex(yr[..., 1:], yi[..., 1:])
    return torch.cat([p0[..., None], body, pny[..., None]], dim=-1)


def pack_spectrum(fu):
    """complex (…,N0,N1,Nf) -> packed planar float32 pair (…,N0,N1,Nf−1)."""
    nf = fu.shape[-1]
    qr, qi = pack_plane0(fu[..., 0], fu[..., nf - 1])
    br = torch.cat([qr[..., None], fu.real[..., 1:nf - 1]], dim=-1)
    bi = torch.cat([qi[..., None], fu.imag[..., 1:nf - 1]], dim=-1)
    return (br.to(torch.float32).contiguous(),
            bi.to(torch.float32).contiguous())


def purify_plane0(yr, yi):
    """Drop the Nyquist rider from packed plane 0 (leaving X0 exactly); the
    body is untouched."""
    qr, qi = yr[..., 0], yi[..., 0]
    fr, fi = _flipconj(qr, qi, (qr.ndim - 2, qr.ndim - 1))
    yr = torch.cat([(0.5 * (qr + fr))[..., None], yr[..., 1:]], dim=-1)
    yi = torch.cat([(0.5 * (qi + fi))[..., None], yi[..., 1:]], dim=-1)
    return yr, yi


def rfft3d(u):
    """numpy-convention rfftn over the last three axes of real float32
    input: complex64 (…,N0,N1,N2/2+1).  Leading axes batch."""
    return unpack_spectrum(*rfft3d_packed(u))


def irfft3d(fu, s):
    """Inverse of ``rfft3d``; ``s`` = the last three physical sizes."""
    return irfft3d_packed(*pack_spectrum(fu), tuple(s)[-3:])
