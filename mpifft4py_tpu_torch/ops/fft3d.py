"""Planar 3D r2c/c2r FFT pipeline over hand-written CUDA kernels.

Port of ``mpifft4py_tpu/ops/pallas_fft3d.py``: the same functions, names and
packed-Hermitian planar layout.  Kernel functions take and return planar
``(re, im)`` float32 pairs; a packed spectrum sits in h = n/2 columns with
column 0 holding X[0] + i·X[n/2].

Fourteen CUDA kernels (``csrc/``; the fused three with template variants)
carry the path, each for every length of the reference's envelope
(``supported_c2c``/``supported_r2c``, through the mixed-radix plans of
``csrc/fft_block.cuh``):

* ``fft_axis`` (``fft_axis_planar``): c2c along a non-last axis;
* ``packed_rfft_last`` / ``packed_irfft_last`` (``rfft_last_packed`` /
  ``irfft_last_packed``): packed r2c / c2r along the last axis;
* ``planar_rfft_last`` / ``planar_irfft_last`` (``rfft_last_planar`` /
  ``irfft_last_planar``): r2c / c2r along the last axis into / from exactly
  nf columns, with the 3/2 rule's truncation, zero-pad and scale folded in;
* ``fft_last`` (``fft_last_planar_c2c``): c2c along the last axis, the first
  stage of ``cfft3d`` and of ``slab.C2C``'s 3/2-rule chain;
* ``packed_rfft_last_zdif`` / ``packed_irfft_last_zdif`` (``zdif.py``; here
  behind ``rfft_last_packed``/``irfft_last_packed`` with ``dif=True``): the
  packed r2c / c2r with the spectrum in the reference's DIF lane order, for
  the packed 2D layout;
* the packed solvers' right-hand-side kernels: ``curl_ifft_x`` (the curl,
  or with ``biot_savart`` the curl ÷ |K|², with the x inverse, for
  ``curl_irfft3d_packed``), ``cross_rfft_z`` (a product, A × B, A × B +
  C × D or a_c·t, with the packed z r2c, for ``cross_rfft_zy_packed`` and
  ``mul_rfft_zy_packed``) and ``fft_x_epilogue`` (the x forward with the
  mask, the projection, curl or divergence, the buoyancy rider and the
  diffusive term, ``fft_x_epilogue_packed``);
* the complex layout's pointwise right-hand side (``csrc/rhs_pointwise.cu``,
  one pass a stage): ``rhs_curl`` (i K × Û), ``rhs_cross`` (A × B of two
  physical stacks) and ``rhs_leray_visc`` (the Leray projection and the
  viscous term), complex64/float32 at the boundary.  Their twins also run
  for complex128/float64 on any device (the "double" precision).

``fused_zy_fwd`` / ``fused_zy_bwd`` keep the reference's contracts as one
launch per stage (see the source note in ``csrc/fft_axis.cu``); so do the
fused right-hand-side functions, whose y stages are ``fft_axis`` launches.

``ops/dense.py`` (rows 19–22) launches complex64 instances of
``fft_axis``, ``fft_last`` and the planar r2c/c2r, counted here too.

Every kernel function has a plain twin (``*_ref``) over ``torch.fft``.  A
wrapper runs the twin for CPU tensors only; for CUDA tensors it launches the
kernel or raises.  ``LAUNCHES`` counts kernel launches by kernel name, each
template variant under its own name (``curl_ifft_x_biot_savart``,
``cross2_rfft_z``, ``mul_rfft_z``, ``fft_x_epilogue_curl``, …).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import profiling, spectral

__all__ = [
    "LAUNCHES", "reset_launches", "supported_c2c", "supported_r2c",
    "supported_r2c_grid",
    "fft_axis_planar", "rfft_last_packed", "irfft_last_packed",
    "fused_zy_fwd", "fused_zy_bwd", "rfft3d_packed", "irfft3d_packed",
    "unpack_plane0", "pack_plane0", "unpack_spectrum", "pack_spectrum",
    "purify_plane0", "rfft3d", "irfft3d", "purify_plane0_dus",
    "curl_fused_ok", "cross_zy_ok", "fft_x_epilogue_ok", "curl_ifft_x",
    "curl_irfft3d_packed", "cross_rfft_z", "cross_rfft_zy_packed",
    "mul_rfft_z", "mul_rfft_zy_packed", "fft_x_epilogue_packed", "cross",
    "kvecs", "kcross", "kdot", "inv_ksq", "rfft_last_planar",
    "irfft_last_planar", "fft_last_planar_c2c", "cfft3d", "rhs_curl",
    "rhs_cross", "rhs_leray_visc",
]

LAUNCHES = {"fft_axis": 0, "packed_rfft_last": 0, "packed_irfft_last": 0,
            "curl_ifft_x": 0, "curl_ifft_x_biot_savart": 0,
            "cross_rfft_z": 0, "cross2_rfft_z": 0, "mul_rfft_z": 0,
            "fft_x_epilogue": 0, "fft_x_epilogue_buoy": 0,
            "fft_x_epilogue_curl": 0, "fft_x_epilogue_div": 0,
            "planar_rfft_last": 0, "planar_irfft_last": 0, "fft_last": 0,
            "packed_rfft_last_zdif": 0, "packed_irfft_last_zdif": 0,
            # rows 19-22, launched by ops/dense.py
            "dense_fft_axis": 0, "dense_fft_last": 0, "dense_rfft_last": 0,
            "dense_irfft_last": 0,
            # the complex layout's pointwise right-hand side
            "rhs_curl": 0, "rhs_cross": 0, "rhs_leray_visc": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _factor(n: int):
    """n = r·m with the largest m <= 128 dividing n; returns (r, m) (the
    reference's ``pallas_fft3d._factor`` without its tuning table and
    override knob)."""
    for m in range(min(n, 128), 0, -1):
        if n % m == 0:
            return n // m, m
    return n, 1


def supported_c2c(n: int) -> bool:
    """The reference's c2c envelope: n = r·m with m <= 128 the largest
    divisor of n, r <= 8 and m >= 8 (so n <= 1024 and every prime factor
    <= 127).  The kernels' mixed-radix plans (``csrc/fft_block.cuh``) serve
    every such n."""
    r, m = _factor(n)
    return r <= 8 and m >= 8


def supported_r2c(n: int) -> bool:
    """The reference's r2c envelope: even n in 16..2048 (a half-length
    FFT of n/2 <= 1024 points)."""
    return n % 2 == 0 and 16 <= n <= 2048


def supported_r2c_grid(shape) -> bool:
    """A 3-D real grid (N0, N1, N2) the r2c chain serves: ``supported_c2c``
    N0 and N1, ``supported_r2c`` N2."""
    return (len(shape) == 3 and supported_c2c(int(shape[0]))
            and supported_c2c(int(shape[1])) and supported_r2c(int(shape[2])))


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


def fft_axis_planar(xr, xi, axis: int, inverse: bool = False, out=None):
    """c2c DFT along a non-last ``axis`` of planar float32 arrays; the
    inverse includes the 1/n scale.  ``out``: an (re, im) pair of
    contiguous float32 tensors of the input's shape to write into (the
    slab's zy stage writes into a peer-visible buffer); returned."""
    on_cpu = _check_float32(xr, xi, *(out or ()))
    if out is not None and any(o.shape != xr.shape for o in out):
        raise ValueError(f"fft_axis_planar: out must be a pair of shape "
                         f"{tuple(xr.shape)}")
    _check_pair(xr, xi)
    axis = axis % xr.ndim
    if axis == xr.ndim - 1:
        raise ValueError("last axis: use the packed r2c/c2r kernels")
    n = int(xr.shape[axis])
    if not supported_c2c(n):
        raise ValueError(f"fft_axis_planar: n={n} outside the kernel envelope")
    if on_cpu:
        yr, yi = fft_axis_planar_ref(xr, xi, axis, inverse)
        return (yr, yi) if out is None else (out[0].copy_(yr),
                                             out[1].copy_(yi))
    pre = math.prod(xr.shape[:axis])
    post = math.prod(xr.shape[axis + 1:])
    yr, yi = out if out is not None else (torch.empty_like(xr),
                                          torch.empty_like(xi))
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


def rfft_last_packed(x, dif: bool = False):
    """real (…, n) -> packed planar (re, im), shape (…, n/2).  ``dif=True``
    (the packed 2D layout): where ``zdif.zdif_ok(n)`` the lanes leave in
    ``zdif.zdif_perm`` order, through ``zdif.rfft_last_zdif`` (row 17)."""
    if dif:
        from . import zdif as zd
        if zd.zdif_active(int(x.shape[-1])):
            return zd.rfft_last_zdif(x)
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


def irfft_last_packed(xr, xi, n: int, dif: bool = False):
    """packed planar (…, n/2) -> real (…, n), scaled by 1/n.  ``dif=True``:
    the pair is in DIF lane order where ``zdif.zdif_ok(n)`` (row 18)."""
    if dif:
        from . import zdif as zd
        if zd.zdif_active(n):
            return zd.irfft_last_zdif(xr, xi, n)
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


# -- planar r2c / c2r along the last axis (the 3/2 rule) ----------------------------
#
# The reference pads the spectral width to a multiple of 128 lanes (a TPU
# workaround); the port's spectra have exactly nf columns.

def rfft_last_planar_ref(x, nf=None, scale: float = 1.0, width=None):
    full = x.shape[-1] // 2 + 1
    nf = full if nf is None else nf
    X = torch.fft.rfft(x, dim=-1)[..., :nf]
    if nf < full:
        X = torch.cat([X[..., :-1], 2.0 * X[..., -1:]], dim=-1)
    X = X * scale
    if width is not None and width > nf:
        X = torch.cat([X, X.new_zeros(X.shape[:-1] + (width - nf,))], -1)
    return X.real.contiguous(), X.imag.contiguous()


def rfft_last_planar(x, nf=None, scale: float = 1.0, width=None, out=None):
    """real (…, n) -> planar (re, im) of shape (…, width), nf = n//2+1 and
    width = nf when None.  ``nf`` < n//2+1 truncates with column nf−1
    doubled (the 3/2 rule's z truncation); ``scale`` multiplies every
    column; columns nf..width−1 are zeros (the pencil's alignment padding
    to Nfp).  ``out``: a contiguous (re, im) pair of the result's shape to
    write into (the pencil's z stage writes into a peer-visible buffer);
    returned."""
    on_cpu = _check_float32(x, *(out or ()))
    n = int(x.shape[-1])
    full = n // 2 + 1
    nf = full if nf is None else int(nf)
    width = nf if width is None else int(width)
    if not supported_r2c(n) or not 2 <= nf <= full or width < nf:
        raise ValueError(f"rfft_last_planar: n={n}, nf={nf}, width={width} "
                         f"outside the kernel envelope")
    shape = x.shape[:-1] + (width,)
    if out is not None and any(o.shape != shape for o in out):
        raise ValueError(f"rfft_last_planar: out must be a pair of shape "
                         f"{tuple(shape)}")
    if on_cpu:
        yr, yi = rfft_last_planar_ref(x, nf, scale, width)
        return (yr, yi) if out is None else (out[0].copy_(yr),
                                             out[1].copy_(yi))
    h = n // 2
    yr, yi = out if out is not None else (
        torch.empty(shape, dtype=torch.float32, device=x.device),
        torch.empty(shape, dtype=torch.float32, device=x.device))
    _launch("planar_rfft_last", "planar_rfft_launch", x.data_ptr(),
            yr.data_ptr(), yi.data_ptr(),
            _twiddles(h, h, -1, x.device).data_ptr(),
            _twiddles(n, h, -1, x.device).data_ptr(),
            x.numel() // n, n, nf, width, int(nf < full), float(scale),
            device=x.device)
    return yr, yi


def irfft_last_planar_ref(xr, xi, n: int, nf_in=None, scale: float = 1.0):
    cut = n // 2 + 1 if nf_in is None else nf_in
    X = torch.complex(xr[..., :cut], xi[..., :cut])
    if cut < n // 2 + 1:
        # the pad's halved Nyquist: net weight 1 after the c2r's 2
        X = torch.cat([X[..., :-1], 0.5 * X[..., -1:]], dim=-1)
    return (torch.fft.irfft(X, n=n, dim=-1) * scale).contiguous()


def irfft_last_planar(xr, xi, n: int, nf_in=None, scale: float = 1.0):
    """planar (…, width) -> real (…, n), scaled by ``scale``/n, from the
    first nf_in columns (nf_in = n//2+1 when None; width >= nf_in, the
    columns beyond read as absent: the pencil's alignment padding).
    ``nf_in`` < n//2+1 zero-pads to n//2+1 with column nf_in−1 at weight 1
    (the 3/2 rule's z pad, whose Nyquist split halves it)."""
    on_cpu = _check_float32(xr, xi)
    _check_pair(xr, xi)
    full = n // 2 + 1
    cut = full if nf_in is None else int(nf_in)
    width = int(xr.shape[-1])
    if not supported_r2c(n) or not 2 <= cut <= full or width < cut:
        raise ValueError(f"irfft_last_planar: n={n}, nf_in={cut} with width "
                         f"{width} outside the kernel envelope")
    if on_cpu:
        return irfft_last_planar_ref(xr, xi, n, cut, scale)
    h = n // 2
    y = torch.empty(xr.shape[:-1] + (n,), dtype=torch.float32,
                    device=xr.device)
    _launch("planar_irfft_last", "planar_irfft_launch", xr.data_ptr(),
            xi.data_ptr(), y.data_ptr(),
            _twiddles(h, h, 1, xr.device).data_ptr(),
            _twiddles(n, h, 1, xr.device).data_ptr(),
            xr.numel() // width, n, cut, width, float(scale),
            device=xr.device)
    return y


# -- c2c along the last axis and the full 3D c2c chain ------------------------------

def fft_last_planar_c2c_ref(xr, xi, inverse: bool = False,
                            scale: float = 1.0):
    yr, yi = fft_axis_planar_ref(xr, xi, -1, inverse)
    if scale != 1.0:
        yr, yi = yr * scale, yi * scale
    return yr, yi


def fft_last_planar_c2c(xr, xi, inverse: bool = False, scale: float = 1.0):
    """c2c DFT along the last axis of planar float32 arrays; the inverse
    includes the 1/n scale, and ``scale`` multiplies either direction (the
    3/2 rule folds its padsize³ factors in here).  Its envelope is
    ``supported_c2c`` (the reference's 128-lane ``supported_c2c_last`` does
    not carry over)."""
    on_cpu = _check_float32(xr, xi)
    _check_pair(xr, xi)
    n = int(xr.shape[-1])
    if not supported_c2c(n):
        raise ValueError(f"fft_last_planar_c2c: n={n} outside the kernel "
                         f"envelope")
    if on_cpu:
        return fft_last_planar_c2c_ref(xr, xi, inverse, scale)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    tw = _twiddles(n, n, 1 if inverse else -1, xr.device)
    _launch("fft_last", "fft_last_launch", xr.data_ptr(), xi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), tw.data_ptr(), xr.numel() // n, n,
            int(inverse), float(scale), device=xr.device)
    return yr, yi


def cfft3d(x, inverse: bool = False):
    """numpy-convention fftn (ifftn) over the last three axes of complex64
    (…, N0, N1, N2): the last-axis c2c, then ``fft_axis`` on y and on x.
    Leading axes batch."""
    if x.ndim < 3:
        raise ValueError("cfft3d needs (…, N0, N1, N2)")
    yr, yi = fft_last_planar_c2c(x.real.contiguous(), x.imag.contiguous(),
                                 inverse)
    yr, yi = fft_axis_planar(yr, yi, axis=x.ndim - 2, inverse=inverse)
    yr, yi = fft_axis_planar(yr, yi, axis=x.ndim - 3, inverse=inverse)
    return torch.complex(yr, yi)


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
    with profiling.span("mpifft.transform.boundary"):
        p0, pny = unpack_plane0(yr, yi, axes=(yr.ndim - 3, yr.ndim - 2))
        body = torch.complex(yr[..., 1:], yi[..., 1:])
        return torch.cat([p0[..., None], body, pny[..., None]], dim=-1)


def pack_spectrum(fu):
    """complex (…,N0,N1,Nf) -> packed planar float32 pair (…,N0,N1,Nf−1)."""
    with profiling.span("mpifft.transform.boundary"):
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


def purify_plane0_dus(yr, yi):
    """``purify_plane0`` as an in-place update of the k2 = 0 column of
    ``yr``/``yi`` (the reference's dynamic-update-slice form); returns them.
    The flip needs the whole (k0, k1) plane, so it runs after the kernels,
    on 1/h of the data."""
    qr, qi = yr[..., 0], yi[..., 0]
    fr, fi = _flipconj(qr, qi, (qr.ndim - 2, qr.ndim - 1))
    qr.copy_(0.5 * (qr + fr))
    qi.copy_(0.5 * (qi + fi))
    return yr, yi


# -- the fused kernels of the packed solvers' right-hand sides ----------------------
#
# The state is a packed pair (3, N0, N1, h); the wavenumbers and 2/3-rule
# masks arrive as the solver's 1-D vectors k0/m0 (N0), k1/m1 (N1), k2/m2 (h).
# The gates are the reference's envelope predicates: the kernels' plans
# serve every length in them, and the tiles of csrc/ always fit one block,
# so no memory budget enters (the reference's VMEM budgets do not carry
# over).

def curl_fused_ok(n0: int) -> bool:
    """The curl + x-inverse kernel serves x length ``n0``: every
    ``supported_c2c`` length."""
    return supported_c2c(n0)


def cross_zy_ok(n1: int, n2: int) -> bool:
    """The cross + z kernel and the y stage serve (n1, n2) planes: every
    ``supported_c2c`` n1 and ``supported_r2c`` n2, 512-class planes
    included (row 13's function: the kernel has no whole-plane working
    set)."""
    return supported_c2c(n1) and supported_r2c(n2)


def fft_x_epilogue_ok(n0: int) -> bool:
    """The x-forward + epilogue kernel serves x length ``n0``: every
    ``supported_c2c`` length."""
    return supported_c2c(n0)


def kvecs(k0, k1, k2):
    """The 1-D wavenumbers as broadcast factors (K0, K1, K2) of an
    (N0, N1, n) grid."""
    return k0[:, None, None], k1[None, :, None], k2[None, None, :]


def _check_stack(name, shape, vecs=()) -> None:
    """A packed or physical 3-stack (3, N0, N1, n) and its 1-D vectors of
    lengths (N0, N1, n)."""
    if len(shape) != 4 or shape[0] != 3:
        raise ValueError(f"{name}: needs a (3, N0, N1, n) stack, got "
                         f"{tuple(shape)}")
    for v, n in zip(vecs, (shape[1], shape[2], shape[3]) * 2):
        if v.shape != (n,):
            raise ValueError(f"{name}: wavenumber/mask vector of shape "
                             f"{tuple(v.shape)} for length {n}")


def cross(a, b):
    """A × B of two (3, …) stacks."""
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def kcross(K, v):
    """K × V for broadcast wavenumber factors K = (K0, K1, K2)."""
    return torch.stack([K[1] * v[2] - K[2] * v[1],
                        K[2] * v[0] - K[0] * v[2],
                        K[0] * v[1] - K[1] * v[0]])


def kdot(K, v):
    """K · V for broadcast wavenumber factors K = (K0, K1, K2)."""
    return K[0] * v[0] + K[1] * v[1] + K[2] * v[2]


def inv_ksq(k0, k1, k2) -> torch.Tensor:
    """1/|K|² from the 1-D factors, with |K|² = 0 taken as 1."""
    ksq = spectral.ksq(k0, k1, k2)
    return 1.0 / torch.where(ksq == 0, 1.0, ksq)


def _curl_pair(ur, ui, K):
    """Planar i K × Û: (re, im) = (−K×Ui, K×Ur)."""
    return -kcross(K, ui), kcross(K, ur)


def curl_ifft_x_ref(ur, ui, k0, k1, k2, with_state: bool = False,
                    biot_savart: bool = False):
    cr, ci = _curl_pair(ur, ui, kvecs(k0, k1, k2))
    if biot_savart:
        inv = inv_ksq(k0, k1, k2)
        cr, ci = cr * inv, ci * inv
    if with_state:
        cr, ci = torch.cat([cr, ur]), torch.cat([ci, ui])
    return fft_axis_planar_ref(cr, ci, axis=1, inverse=True)


def curl_ifft_x(ur, ui, k0, k1, k2, with_state: bool = False,
                biot_savart: bool = False):
    """x inverse (1/N0) of i K × Û (÷ |K|² with ``biot_savart``) for a packed
    state (3, N0, N1, h), and with ``with_state`` of Û itself from the same
    pass: one pair (3 or 6, N0, N1, h), the curl's components first."""
    on_cpu = _check_float32(ur, ui, k0, k1, k2)
    _check_pair(ur, ui)
    _check_stack("curl_ifft_x", ur.shape, (k0, k1, k2))
    _, n0, n1, h = ur.shape
    if not curl_fused_ok(n0):
        raise ValueError(f"curl_ifft_x: N0={n0} outside the kernel envelope")
    if on_cpu:
        return curl_ifft_x_ref(ur, ui, k0, k1, k2, with_state, biot_savart)
    shape = (6 if with_state else 3, n0, n1, h)
    yr = torch.empty(shape, dtype=torch.float32, device=ur.device)
    yi = torch.empty_like(yr)
    _launch("curl_ifft_x_biot_savart" if biot_savart else "curl_ifft_x",
            "curl_ifft_x_launch", ur.data_ptr(), ui.data_ptr(),
            k0.data_ptr(), k1.data_ptr(), k2.data_ptr(), yr.data_ptr(),
            yi.data_ptr(), _twiddles(n0, n0, 1, ur.device).data_ptr(),
            n0, n1, h, int(with_state), int(biot_savart), device=ur.device)
    return yr, yi


def curl_irfft3d_packed_ref(ur, ui, k0, k1, k2, s, biot_savart: bool = False,
                            with_state: bool = False):
    w = fused_zy_bwd_ref(*curl_ifft_x_ref(ur, ui, k0, k1, k2, with_state,
                                          biot_savart), int(s[-1]))
    return (w[:3], w[3:]) if with_state else w


def curl_irfft3d_packed(ur, ui, k0, k1, k2, s, biot_savart: bool = False,
                        with_state: bool = False):
    """W = irfft3d of i K × Û for a packed state (3, N0, N1, h), of
    i K × Û / |K|² with ``biot_savart`` (the velocity of a vorticity
    state); ``s`` is the physical shape.  The curl rides the x-inverse
    kernel, then one y inverse and one z c2r run over all the components.
    ``with_state`` also returns the state's own inverse from the same pass:
    (W, U), views of one (6, N0, N1, N2) tensor."""
    w = fused_zy_bwd(*curl_ifft_x(ur, ui, k0, k1, k2, with_state,
                                  biot_savart), int(s[-1]))
    return (w[:3], w[3:]) if with_state else w


# -- a product of physical stacks with the packed z r2c behind it ----------------
#
# One kernel (csrc/cross_rfft_z.cu) over three loads, each counted under its
# own name: "cross_rfft_z" (A × B), "cross2_rfft_z" (A × B + C × D, MHD) and
# "mul_rfft_z" (a_c·t, the Boussinesq scalar flux).

_PRODUCT_OPS = {"cross_rfft_z": 0, "cross2_rfft_z": 1, "mul_rfft_z": 2}


def _product_rfft_z(name, ins, twin):
    """Validates the stacks of a product (3, …, n) [and the scalar field
    (1, …, n) of ``mul``] and launches its kernel; on the CPU, runs
    ``twin``."""
    a = ins[0]
    on_cpu = _check_float32(*ins)
    want = [a.shape] * len(ins)
    if name == "mul_rfft_z":
        want[1] = (1,) + tuple(a.shape[1:])
    if a.ndim < 2 or a.shape[0] != 3 or [x.shape for x in ins] != want:
        raise ValueError(f"{name}: needs (3, …, n) stacks (the scalar field "
                         f"of mul (1, …, n)), got "
                         f"{[tuple(x.shape) for x in ins]}")
    n = int(a.shape[-1])
    if not supported_r2c(n):
        raise ValueError(f"{name}: n={n} outside the kernel envelope")
    if on_cpu:
        return twin(*ins)
    h = n // 2
    yr = torch.empty(a.shape[:-1] + (h,), dtype=torch.float32,
                     device=a.device)
    yi = torch.empty_like(yr)
    c, d = (ins[2].data_ptr(), ins[3].data_ptr()) if len(ins) == 4 \
        else (None, None)
    _launch(name, "cross_rfft_z_launch", a.data_ptr(), ins[1].data_ptr(), c,
            d, yr.data_ptr(), yi.data_ptr(),
            _twiddles(h, h, -1, a.device).data_ptr(),
            _twiddles(n, h, -1, a.device).data_ptr(),
            a[0].numel() // n, n, _PRODUCT_OPS[name], device=a.device)
    return yr, yi


def _cross_ins(a, b, c, d):
    if (c is None) != (d is None):
        raise ValueError("cross2 takes both c and d")
    return (a, b) if c is None else (a, b, c, d)


def cross_rfft_z_ref(a, b, c=None, d=None):
    f = cross(a, b)
    if c is not None:
        f = f + cross(c, d)
    return rfft_last_packed_ref(f)


def cross_rfft_z(a, b, c=None, d=None):
    """Packed z r2c of A × B [+ C × D] for physical 3-stacks (3, …, n): a
    pair (3, …, n/2).  The product forms in shared memory."""
    return _product_rfft_z("cross_rfft_z" if c is None else "cross2_rfft_z",
                           _cross_ins(a, b, c, d), cross_rfft_z_ref)


def mul_rfft_z_ref(a, t):
    return rfft_last_packed_ref(a * t)


def mul_rfft_z(a, t):
    """Packed z r2c of a_c·t for a physical 3-stack ``a`` (3, …, n) and a
    scalar field ``t`` (1, …, n): a pair (3, …, n/2)."""
    return _product_rfft_z("mul_rfft_z", (a, t), mul_rfft_z_ref)


def cross_rfft_zy_packed_ref(a, b, c=None, d=None):
    return fft_axis_planar_ref(*cross_rfft_z_ref(a, b, c, d), axis=2)


def _check_zy(name, a) -> None:
    _check_stack(name, a.shape)
    if not cross_zy_ok(a.shape[2], a.shape[3]):
        raise ValueError(f"{name}: (N1, N2) = {tuple(a.shape[2:])} outside "
                         f"the kernel envelope")


def cross_rfft_zy_packed(a, b, c=None, d=None):
    """(A × B [+ C × D]) with the packed z r2c and the y c2c behind it, for
    physical 3-stacks (3, N0, N1, N2): the pair (3, N0, N1, N2/2), x pending
    (feed ``fft_x_epilogue_packed``).  The product never lands in device
    memory; the y stage is an ``fft_axis`` launch."""
    _check_zy("cross_rfft_zy_packed", a)
    return fft_axis_planar(*cross_rfft_z(a, b, c, d), axis=2)


def mul_rfft_zy_packed_ref(a, t):
    return fft_axis_planar_ref(*mul_rfft_z_ref(a, t), axis=2)


def mul_rfft_zy_packed(a, t):
    """(a_c·t) for a physical 3-stack (3, N0, N1, N2) and a scalar field
    ``t`` (1, N0, N1, N2), with the packed z r2c and the y c2c behind it:
    the pair (3, N0, N1, N2/2), x pending (the Boussinesq scalar flux u·θ,
    for ``fft_x_epilogue_packed`` in mode "div")."""
    _check_zy("mul_rfft_zy_packed", a)
    return fft_axis_planar(*mul_rfft_z(a, t), axis=2)


# -- the x forward with the right-hand side's epilogue -----------------------------

_EPILOGUE_MODES = {"project": 0, "curl": 1, "div": 2}


def fft_x_epilogue_packed_ref(fzr, fzi, sr, si, k0, k1, k2, m0, m1, m2,
                              mode: str, visc: float, buoy=None):
    Fr, Fi = fft_axis_planar_ref(fzr, fzi, axis=1)
    K = kvecs(k0, k1, k2)
    mask = m0[:, None, None] * (m1[None, :, None] * m2[None, None, :])
    Fr, Fi = Fr * mask, Fi * mask
    if buoy is not None:                  # unmasked θ̂ joins after the mask
        tr, ti, ri = buoy
        Fr[2] += ri * tr[0]
        Fi[2] += ri * ti[0]
    nk = visc * spectral.ksq(k0, k1, k2)
    if mode == "div":
        return torch.stack([kdot(K, Fi) - nk * sr[0],
                            -kdot(K, Fr) - nk * si[0]])[:, None]
    if mode == "curl":
        return torch.stack([-kcross(K, Fi) - nk * sr,
                            kcross(K, Fr) - nk * si])
    inv = inv_ksq(k0, k1, k2)
    dr, di = kdot(K, Fr) * inv, kdot(K, Fi) * inv
    out = torch.empty((2,) + tuple(fzr.shape), dtype=torch.float32,
                      device=fzr.device)
    for c in range(3):
        out[0, c] = Fr[c] - K[c] * dr - nk * sr[c]
        out[1, c] = Fi[c] - K[c] * di - nk * si[c]
    return out


def fft_x_epilogue_packed(fzr, fzi, sr, si, k0, k1, k2, m0, m1, m2,
                          mode: str, visc: float, buoy=None, out=None):
    """x forward of the pair after ``cross_rfft_zy_packed`` (or
    ``mul_rfft_zy_packed``) with the right-hand side's epilogue: the
    2/3-rule mask, then ``mode``

      "project": the Leray projection, F̂ − K (K·F̂)/|K|²;
      "curl":    i K × F̂;
      "div":     −i K · F̂, with a one-component state and output;

    then − visc·k²·S, with ``(sr, si)`` the packed state (unmasked):
    (3, N0, N1, h), or (1, N0, N1, h) for "div".  ``buoy=(tr, ti, ri)``
    (mode "project" only) adds ri·θ̂ to F̂'s third component after the mask
    and before the projection, θ̂ = (tr, ti) the (1, N0, N1, h) scalar state
    (unmasked).  Returns the increment as one (2, ns, N0, N1, h) tensor whose
    [0]/[1] are the re/im planes, or writes it into ``out`` (such a view
    with contiguous [0] and [1]) and returns that.  The plane-0 rider is not
    purified here: callers apply ``purify_plane0_dus``."""
    if mode not in _EPILOGUE_MODES:
        raise ValueError(f"mode must be one of {tuple(_EPILOGUE_MODES)}, "
                         f"got {mode!r}")
    if buoy is not None and mode != "project":
        raise ValueError("the buoyancy rider takes mode='project'")
    m0, m1, m2 = (m.to(torch.float32) for m in (m0, m1, m2))
    extra = () if buoy is None else tuple(buoy[:2])
    on_cpu = _check_float32(fzr, fzi, sr, si, *extra, k0, k1, k2, m0, m1, m2)
    _check_pair(fzr, fzi)
    _check_pair(sr, si)
    _check_stack("fft_x_epilogue_packed", fzr.shape,
                 (k0, k1, k2, m0, m1, m2))
    ns = 1 if mode == "div" else 3
    one = (1,) + tuple(fzr.shape[1:])
    if tuple(sr.shape) != (ns,) + one[1:]:
        raise ValueError(f"fft_x_epilogue_packed: mode {mode!r} takes a "
                         f"{(ns,) + one[1:]} state, got {tuple(sr.shape)}")
    if any(tuple(t.shape) != one for t in extra):
        raise ValueError(f"fft_x_epilogue_packed: the buoyancy rider is a "
                         f"{one} pair, got {[tuple(t.shape) for t in extra]}")
    _, n0, n1, h = fzr.shape
    if not fft_x_epilogue_ok(n0):
        raise ValueError(f"fft_x_epilogue_packed: N0={n0} outside the "
                         f"kernel envelope")
    shape = (2, ns, n0, n1, h)
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != torch.float32
                            or out.device != fzr.device
                            or not (out[0].is_contiguous()
                                    and out[1].is_contiguous())):
        raise ValueError(f"fft_x_epilogue_packed: out must be a float32 "
                         f"{shape} tensor on {fzr.device} with contiguous "
                         f"[0] and [1]")
    if on_cpu:
        res = fft_x_epilogue_packed_ref(fzr, fzi, sr, si, k0, k1, k2,
                                        m0, m1, m2, mode, visc, buoy)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=fzr.device)
    name = ("fft_x_epilogue" if mode == "project" else
            f"fft_x_epilogue_{mode}") + ("_buoy" if buoy is not None else "")
    tr, ti = (t.data_ptr() for t in extra) if extra else (None, None)
    _launch(name, "fft_x_epilogue_launch", fzr.data_ptr(),
            fzi.data_ptr(), sr.data_ptr(), si.data_ptr(), tr, ti,
            k0.data_ptr(), k1.data_ptr(), k2.data_ptr(), m0.data_ptr(),
            m1.data_ptr(), m2.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), _twiddles(n0, n0, -1, fzr.device).data_ptr(),
            n0, n1, h, float(visc), _EPILOGUE_MODES[mode],
            float(buoy[2]) if buoy is not None else 0.0, device=fzr.device)
    return out


# -- the complex layout's pointwise right-hand side ---------------------------------
#
# One kernel a stage (csrc/rhs_pointwise.cu) for ``NavierStokes3D.rhs``: the
# curl i K × Û, the product A × B of two physical 3-stacks, and the Leray
# projection with the viscous term.  The twins are the solver's eager
# expressions; they run for CPU tensors, and for complex128/float64 on any
# device.  The kernels take complex64/float32 on CUDA; an input that is
# not contiguous is copied first.


def _rhs_route(name, fields, vecs=()) -> bool:
    """Validates a pointwise right-hand-side function's tensors, all on one
    device: complex ``fields`` of one dtype with wavenumbers ``vecs`` of
    its real dtype (the curl, the projection), or real fields of one dtype
    (the product).  True where its kernel launches (CUDA complex64 or
    float32), False where its twin runs."""
    dtype = fields[0].dtype
    reals = {torch.complex64: torch.float32, torch.complex128: torch.float64}
    if (dtype not in (reals if vecs else reals.values())
            or any(t.dtype != dtype for t in fields)
            or any(v.dtype != reals[dtype] for v in vecs)):
        want = ("complex64/complex128 fields and wavenumbers of their real "
                "dtype" if vecs else "float32/float64 fields")
        raise TypeError(f"{name}: needs {want} of one dtype, got "
                        f"{[str(t.dtype) for t in (*fields, *vecs)]}")
    devices = {t.device for t in (*fields, *vecs)}
    if len(devices) != 1 or {d.type for d in devices} - {"cpu", "cuda"}:
        raise ValueError(f"{name}: tensors must all be on the CPU or all on "
                         f"one CUDA device, got {sorted(map(str, devices))}")
    return (fields[0].device.type == "cuda"
            and dtype in (torch.complex64, torch.float32))


def _complex_stack(name, fields, k0, k1, k2):
    """Shape checks of a complex (3, N0, N1, nf) stack (several of one
    shape) and its 1-D wavenumbers; the stack's (N0, N1, nf)."""
    shape = tuple(fields[0].shape)
    if any(tuple(f.shape) != shape for f in fields):
        raise ValueError(f"{name}: stacks of different shapes "
                         f"{[tuple(f.shape) for f in fields]}")
    _check_stack(name, shape, (k0, k1, k2))
    if math.prod(shape[1:]) > 2 ** 31 - 1:
        raise ValueError(f"{name}: a (N0, N1, nf) plane of "
                         f"{math.prod(shape[1:])} values is beyond the "
                         f"kernel's 32-bit indices")
    return shape[1:]


def rhs_curl_ref(u, k0, k1, k2):
    return 1j * kcross(kvecs(k0, k1, k2), u)


def rhs_curl(u, k0, k1, k2):
    """i K × Û of a complex spectral 3-stack (3, N0, N1, nf) from the 1-D
    wavenumbers k0 (N0), k1 (N1), k2 (nf): one read of Û and one write."""
    n0, n1, nf = _complex_stack("rhs_curl", (u,), k0, k1, k2)
    if not _rhs_route("rhs_curl", (u,), (k0, k1, k2)):
        return rhs_curl_ref(u, k0, k1, k2)
    u, k0, k1, k2 = (t.contiguous() for t in (u, k0, k1, k2))
    y = torch.empty_like(u)
    _launch("rhs_curl", "rhs_curl_launch", u.data_ptr(), k0.data_ptr(),
            k1.data_ptr(), k2.data_ptr(), y.data_ptr(), n0, n1, nf,
            device=u.device)
    return y


def rhs_cross_ref(a, b):
    return cross(a, b)


def rhs_cross(a, b):
    """A × B of two real (3, …) stacks of one shape (the physical velocity
    and vorticity, on the N or the 3/2 rule's M grid): six fields read,
    three written."""
    if a.ndim < 2 or a.shape[0] != 3 or a.shape != b.shape:
        raise ValueError(f"rhs_cross: needs two (3, …) stacks of one shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if not _rhs_route("rhs_cross", (a, b)):
        return rhs_cross_ref(a, b)
    a, b = a.contiguous(), b.contiguous()
    y = torch.empty_like(a)
    _launch("rhs_cross", "rhs_cross_launch", a.data_ptr(), b.data_ptr(),
            y.data_ptr(), a[0].numel(), device=a.device)
    return y


def rhs_leray_visc_ref(f, u, k0, k1, k2, nu: float):
    K0, K1, K2v = kvecs(k0, k1, k2)
    ksq = K0 * K0 + K1 * K1 + K2v * K2v
    div = ((K0 * f[0] + K1 * f[1] + K2v * f[2])
           / torch.where(ksq == 0, 1, ksq))
    dU = f - torch.stack([K0 * div, K1 * div, K2v * div])
    return dU - (nu * ksq)[None] * u


def rhs_leray_visc(f, u, k0, k1, k2, nu: float):
    """F̂ − K (K·F̂)/|K|² − ν |K|² Û for complex spectral 3-stacks F̂ (the
    nonlinear term) and Û (the state) of one shape (3, N0, N1, nf), with
    |K|² = 0 taken as 1 in the divisor: F̂ and Û read once, the increment
    written once."""
    n0, n1, nf = _complex_stack("rhs_leray_visc", (f, u), k0, k1, k2)
    if not _rhs_route("rhs_leray_visc", (f, u), (k0, k1, k2)):
        return rhs_leray_visc_ref(f, u, k0, k1, k2, nu)
    f, u, k0, k1, k2 = (t.contiguous() for t in (f, u, k0, k1, k2))
    y = torch.empty_like(f)
    _launch("rhs_leray_visc", "rhs_leray_visc_launch", f.data_ptr(),
            u.data_ptr(), k0.data_ptr(), k1.data_ptr(), k2.data_ptr(),
            y.data_ptr(), n0, n1, nf, float(nu), device=f.device)
    return y
