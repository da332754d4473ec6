"""The DIF lane order of the packed z spectrum, and the kernels that emit it.

Port of ``mpifft4py_tpu/ops/pallas_zdif.py``.  The reference splits the
packed z transform in frequency (n = r·128, r ∈ {4, 6, 8}) to cut its
dense MXU matmuls, and the split leaves the spectrum in a k-decimated lane
order: k = r·t + b (t < 64) sits at lane ``off[b] + t``, where slot p holds
the 64-lane pieces [b = p | b = r − p] and slot 0 holds [0 | r/2].  Lane 0
is still the packed rider X₀ + i·X_{n/2}.  The 2D solver's packed layout
keeps its k1 lanes in this order (``models/navier_stokes_2d.py``), so the
port emits it too.

On the card the split buys nothing: the port's packed r2c/c2r is already a
half-length Stockham FFT of O(n log n) work.  Rows 17–18 are therefore the
packed r2c and c2r with the lane order as a template parameter: the
forward (``csrc/planar_rfft.cu``'s persistent r2c in its packed-DIF output
mode) stages column k of a row at lane ``zdif_lane(k, n)`` before the row's
bulk store, the inverse (``csrc/packed_rfft.cu``) reads k and its partner
h − k from their lanes; ``zdif_lane`` below is the closed form the CUDA
source repeats (``zdif_k`` is its inverse).

``MPIFFT4PY_TPU_ZDIF`` (the reference's force/off knob) is not ported: the
gate is the shape predicate ``zdif_ok`` alone.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import fft3d as p3

__all__ = ["zdif_ok", "zdif_active", "zdif_lane", "zdif_k", "zdif_perm",
           "zdif_iperm", "dif_interleave", "dif_deinterleave",
           "rfft_last_zdif", "irfft_last_zdif", "rfft_last_zdif_ref",
           "irfft_last_zdif_ref"]

_M = 128          # the reference's per-block DFT size: n = r·_M


def zdif_ok(n: int) -> bool:
    """Shape gate: n = r·128 with even r in [4, 8] (512/768/1024-class)."""
    return n % 256 == 0 and 4 <= n // _M <= 8


def zdif_active(n: int) -> bool:
    """Whether the packed 2D layout keeps its lanes in DIF order."""
    return zdif_ok(n)


def zdif_k(lane, n: int):
    """lane -> k of the DIF order, in closed form (numpy arrays or ints):
    slot p = lane // 128, half = (lane // 64) % 2, t = lane % 64;
    b = (0, r/2)[half] at p = 0, (p, r − p)[half] else; k = r·t + b."""
    r = n // _M
    lane = np.asarray(lane)
    p, half, t = lane // _M, (lane // 64) % 2, lane % 64
    b = np.where(p == 0, np.where(half == 1, r // 2, 0),
                 np.where(half == 1, r - p, p))
    return r * t + b


def zdif_lane(k, n: int):
    """k -> lane of the DIF order, in closed form: b = k mod r, t = k // r,
    lane = off[b] + t with off[r/2] = 64 and otherwise
    off[b] = 128·min(b, r − b) + 64·[b > r/2]."""
    r = n // _M
    k = np.asarray(k)
    b, t = k % r, k // r
    off = np.where(b == r // 2, 64,
                   _M * np.minimum(b, r - b) + 64 * (b > r // 2))
    return off + t


@lru_cache(maxsize=None)
def zdif_perm(n: int) -> np.ndarray:
    """lane -> k map of the DIF output order (length h; perm[0] == 0, the
    rider lane).  Packed vectors follow as v_perm = v[zdif_perm(n)]."""
    if not zdif_ok(n):
        raise ValueError(f"zdif_perm: n={n} outside the DIF gate")
    return zdif_k(np.arange(n // 2), n)


@lru_cache(maxsize=None)
def zdif_iperm(n: int) -> np.ndarray:
    """k -> lane inverse of ``zdif_perm``."""
    if not zdif_ok(n):
        raise ValueError(f"zdif_iperm: n={n} outside the DIF gate")
    return zdif_lane(np.arange(n // 2), n)


@lru_cache(maxsize=None)
def _piece_offsets(n: int):
    """Lane offset of residue b's contiguous 64-lane piece: slot
    p = min(b, r − b) holds [b = p | b = r − p] (slot 0: [0 | r/2])."""
    return tuple(int(o) for o in zdif_lane(np.arange(n // _M), n))


def dif_interleave(x, n: int):
    """DIF-ordered lanes (…, h) -> natural k order: the r 64-lane pieces,
    stacked and interleaved (``x[..., zdif_iperm(n)]``)."""
    h = n // 2
    if x.shape[-1] != h:
        raise ValueError(f"dif_interleave: width {x.shape[-1]} for n={n}")
    pieces = [x[..., o:o + _M // 2] for o in _piece_offsets(n)]
    return torch.stack(pieces, dim=-1).reshape(x.shape[:-1] + (h,))


def dif_deinterleave(x, n: int):
    """Natural k order (…, h) -> DIF lane order, as a (64, r) view whose r
    columns are concatenated in slot order (``x[..., zdif_perm(n)]``)."""
    r = n // _M
    if x.shape[-1] != n // 2:
        raise ValueError(f"dif_deinterleave: width {x.shape[-1]} for n={n}")
    v = x.reshape(x.shape[:-1] + (_M // 2, r))
    off = _piece_offsets(n)
    return torch.cat([v[..., b] for b in sorted(range(r), key=off.__getitem__)],
                     dim=-1)


def _index(perm: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(perm).to(device)


def _check_n(name: str, n: int) -> None:
    if not zdif_ok(n):
        raise ValueError(f"{name}: n={n} outside the DIF gate (n = r·128, "
                         f"r in 4, 6, 8)")


# -- row 17: the packed r2c in DIF lane order ------------------------------------

def rfft_last_zdif_ref(x):
    yr, yi = p3.rfft_last_packed_ref(x)
    p = _index(zdif_perm(int(x.shape[-1])), x.device)
    return yr[..., p].contiguous(), yi[..., p].contiguous()


def rfft_last_zdif(x):
    """real (…, n) -> packed planar (re, im) (…, n/2) in DIF lane order:
    lane l holds X[zdif_perm(n)[l]], lane 0 the rider X₀ + i·X_{n/2}."""
    on_cpu = p3._check_float32(x)
    n = int(x.shape[-1])
    _check_n("rfft_last_zdif", n)
    if on_cpu:
        return rfft_last_zdif_ref(x)
    h = n // 2
    yr = torch.empty(x.shape[:-1] + (h,), dtype=torch.float32,
                     device=x.device)
    yi = torch.empty_like(yr)
    p3._launch("packed_rfft_last_zdif", "packed_rfft_zdif_launch",
               x.data_ptr(), yr.data_ptr(), yi.data_ptr(),
               p3._twiddles(h, h, -1, x.device).data_ptr(),
               p3._twiddles(n, h, -1, x.device).data_ptr(),
               x.numel() // n, n, device=x.device)
    return yr, yi


# -- row 18: the packed c2r from DIF lane order ------------------------------------

def irfft_last_zdif_ref(xr, xi, n: int):
    ip = _index(zdif_iperm(n), xr.device)
    return p3.irfft_last_packed_ref(xr[..., ip], xi[..., ip], n)


def irfft_last_zdif(xr, xi, n: int):
    """DIF-ordered packed planar (…, n/2) -> real (…, n), scaled by 1/n."""
    on_cpu = p3._check_float32(xr, xi)
    p3._check_pair(xr, xi)
    _check_n("irfft_last_zdif", n)
    if xr.shape[-1] != n // 2:
        raise ValueError(f"irfft_last_zdif: width {xr.shape[-1]} for n={n}")
    if on_cpu:
        return irfft_last_zdif_ref(xr, xi, n)
    h = n // 2
    y = torch.empty(xr.shape[:-1] + (n,), dtype=torch.float32,
                    device=xr.device)
    p3._launch("packed_irfft_last_zdif", "packed_irfft_zdif_launch",
               xr.data_ptr(), xi.data_ptr(), y.data_ptr(),
               p3._twiddles(h, h, 1, xr.device).data_ptr(),
               p3._twiddles(n, h, 1, xr.device).data_ptr(),
               xr.numel() // h, n, device=xr.device)
    return y
