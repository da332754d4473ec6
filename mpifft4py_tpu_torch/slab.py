"""Slab decomposition of 3D FFTs, on one device.

Port of ``mpifft4py_tpu/slab.py`` at P == 1 (the slab's single-device fast
path).  Scaling follows numpy: ``ifftn(fftn(u)) == u``.

Two routes, chosen by a pure predicate on precision and shape
(``_kernel3d_ok``, the counterpart of the reference's ``_pallas3d_ok``):

* the kernel path (float32, every axis in the kernels' envelope): the
  packed planar chain of ``ops.fft3d`` — on the card the hand-written CUDA
  kernels, on the CPU their plain twins through the same glue;
* otherwise (``"double"``, other sizes) ``ops.fft_core`` over ``torch.fft``,
  as the reference falls back to ``jnp.fft``.

The packed interface (``forward_packed_fn``/``backward_packed_fn``) hands
out the packed planar pair itself, with no complex boundary; its envelope
is the reference's (float32, ``(N2/2) % 128 == 0``, ``dealias`` None or
"2/3-rule"), so both packages accept and refuse the same configurations.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import BaseFFT
from .ops import fft3d as p3
from .ops import fft_core as fc
from .utils.spectral import dealias_cutoffs

__all__ = ["R2C", "C2C"]

_ITEM_32 = "ROADMAP.md queue 1 item 4 (3/2-rule, kernel rows 8-9)"
_ITEM_C2C = "ROADMAP.md queue 1 item 4 (C2C, kernel row 10)"


class R2C(BaseFFT):
    """Real ↔ complex 3D transform.

    Physical space: real (N0, N1, N2).  Spectral space: complex
    (N0, N1, Nf = N2//2 + 1).  Transforms act on the last three axes, so a
    stack of fields (C, N0, N1, N2) transforms in one call.
    """

    ndim = 3

    def _validate(self):
        for n in self.N:
            if n % 2:
                raise ValueError(f"grid sizes must be even, got {tuple(self.N)}")
        M = self.padsize * self.N
        if not np.allclose(M, np.round(M)):
            raise ValueError(f"padsize*N must be integral, got {M}")
        self.M = np.round(M).astype(np.int64)
        self._mask = None

    @property
    def Nf(self) -> int:
        return int(self.N[2]) // 2 + 1

    # -- shapes (reference-parity helpers; local == global at P == 1) -------

    def real_shape(self):
        return tuple(int(n) for n in self.N)

    def complex_shape(self):
        return (int(self.N[0]), int(self.N[1]), self.Nf)

    def complex_shape_T(self):
        """Transposed (pre-Alltoall) spectral shape."""
        return (int(self.N[0]), int(self.N[1]), self.Nf)

    def complex_shape_I(self):
        """Alltoall send-view shape (P, Np0, Np1, Nf)."""
        return (1, int(self.N[0]), int(self.N[1]), self.Nf)

    def global_real_shape(self):
        return self.real_shape()

    def global_complex_shape(self):
        return self.complex_shape()

    def real_shape_padded(self):
        return tuple(int(m) for m in self.M)

    def global_real_shape_padded(self):
        return self.real_shape_padded()

    def work_shape(self, dealias=None):
        """Physical-space (fftn input / ifftn output) shape."""
        return self.real_shape_padded() if dealias == "3/2-rule" \
            else self.real_shape()

    def global_work_shape(self, dealias=None):
        return self.work_shape(dealias)

    def real_local_slice(self, rank: int = 0, padsize: float = 1.0):
        N = [int(round(padsize * n)) for n in self.N]
        return (slice(rank * N[0], (rank + 1) * N[0]), slice(0, N[1]),
                slice(0, N[2]))

    def complex_local_slice(self, rank: int = 0):
        N1 = int(self.N[1])
        return (slice(0, int(self.N[0])), slice(rank * N1, (rank + 1) * N1),
                slice(0, self.Nf))

    # -- wavenumber and coordinate meshes, built on the device ---------------

    def _k_local(self, dtype):
        """Spectral wavenumbers (k0, k1, k2) for the layout (N0, N1, Nf)."""
        def full(n):
            j = torch.arange(n, device=self.device)
            return torch.where(j < n // 2, j, j - n).to(dtype)
        return (full(int(self.N[0])), full(int(self.N[1])),
                torch.arange(self.Nf, device=self.device).to(dtype))

    def get_local_wavenumbermesh(self) -> torch.Tensor:
        """(3, N0, N1, Nf) integer wavenumbers."""
        return torch.stack(torch.meshgrid(*self._k_local(self.float),
                                          indexing="ij"))

    def get_scaled_local_wavenumbermesh(self) -> torch.Tensor:
        """Physical wavenumbers k_i·2π/L_i."""
        scale = 2 * np.pi / self.L
        k = [ki * _as_working(s, self.float)
             for ki, s in zip(self._k_local(self.float), scale)]
        return torch.stack(torch.meshgrid(*k, indexing="ij"))

    def get_dealias_filter(self) -> torch.Tensor:
        """2/3-rule boolean mask (N0, N1, Nf)."""
        return self._dealias_local()

    def _dealias_local(self) -> torch.Tensor:
        if self._mask is None:
            c = dealias_cutoffs(self.N)
            k0, k1, k2 = self._k_local(torch.float32)
            self._mask = ((k0.abs()[:, None, None] < c[0])
                          & (k1.abs()[None, :, None] < c[1])
                          & (k2.abs()[None, None, :] < c[2]))
        return self._mask

    def get_local_mesh(self) -> torch.Tensor:
        """(3, N0, N1, N2) physical coordinates."""
        d = (self.L / self.N).astype(np.float64)
        x = [torch.arange(int(n), dtype=self.float, device=self.device)
             * _as_working(di, self.float) for n, di in zip(self.N, d)]
        return torch.stack(torch.meshgrid(*x, indexing="ij"))

    # -- routes ------------------------------------------------------------------

    def _kernel3d_ok(self) -> bool:
        """The hand-written kernel path: float32, even N2, every axis in the
        kernels' envelope (2^a·3^b, b <= 1, 16..1024).  A pure predicate: the
        CPU takes the same glue through the kernels' plain twins."""
        return (self.float == torch.float32
                and p3.supported_r2c(int(self.N[2]))
                and p3.supported_c2c(int(self.N[0]))
                and p3.supported_c2c(int(self.N[1])))

    # -- the packed interface (P == 1) ------------------------------------------

    @property
    def packed_z_perm(self):
        """lane → k2 map of the packed pair's last axis: always None, the
        natural 0..h−1 order (the reference's zdif lane order at N2 >= 512
        does not carry over)."""
        return None

    def _packed_iface_ok(self, dealias) -> bool:
        """The reference's envelope of the packed interface, on the port's
        kernel path: float32, every axis in the kernels' envelope,
        (N2/2) % 128 == 0, ``dealias`` None or "2/3-rule"."""
        return (dealias in (None, "2/3-rule") and self._kernel3d_ok()
                and (int(self.N[2]) // 2) % 128 == 0)

    def _packed_gate_is_serial(self, dealias) -> bool:
        """Entry gate of the packed interface: raises outside the envelope;
        True (the serial kernel chain serves it: P == 1)."""
        if not self._packed_iface_ok(dealias):
            raise ValueError(
                "packed interface needs a float32 R2C with every axis in the "
                "kernels' envelope, (N2/2) % 128 == 0, and dealias in "
                "(None, '2/3-rule')")
        return True

    def _packed_mask_local(self, h):
        """2/3-rule mask (N0, N1, h) over the packed pair (k2 = 0..h−1)."""
        return self._dealias_local()[..., :h]

    def forward_packed_fn(self, dealias=None):
        """real (…, N0, N1, N2) -> packed planar pair (…, N0, N1, N2/2), no
        complex boundary.  Plane k2 = 0 carries X0 + i·X_Nyquist; with the
        2/3 rule the rider is purified away and the pair is the masked
        spectrum on k2 = 0..h−1.  Leading dims batch."""
        self._packed_gate_is_serial(dealias)
        return lambda u: self._fwd_packed(u, dealias)

    def _fwd_packed(self, u, dealias):
        yr, yi = p3.rfft3d_packed(u.contiguous())
        if dealias == "2/3-rule":
            p3.purify_plane0_dus(yr, yi)
            keep = self._packed_mask_local(yr.shape[-1])
            yr, yi = yr.masked_fill(~keep, 0), yi.masked_fill(~keep, 0)
        return yr, yi

    def backward_packed_fn(self, dealias=None):
        """Inverse of ``forward_packed_fn`` (same envelope): a pair (or a
        (2, …) tensor) -> real (…, N0, N1, N2)."""
        self._packed_gate_is_serial(dealias)
        s = self.real_shape()

        def bwd(pair):
            yr, yi = pair
            if dealias == "2/3-rule":
                keep = self._packed_mask_local(yr.shape[-1])
                yr, yi = yr.masked_fill(~keep, 0), yi.masked_fill(~keep, 0)
            return p3.irfft3d_packed(yr.contiguous(), yi.contiguous(), s)
        return bwd

    def _check_dealias(self, dealias):
        if dealias == "3/2-rule":
            raise NotImplementedError(f"dealias='3/2-rule': see {_ITEM_32}")
        if dealias not in (None, "2/3-rule"):
            raise ValueError(f"unknown dealias={dealias!r}")

    def _fwd_kernel(self, u, dealias):
        if dealias == "2/3-rule":
            # mask in the packed planar domain (the packed forward: purify
            # the Nyquist rider, mask the pair), emit a zero Nyquist column
            x = torch.complex(*self._fwd_packed(u, dealias))
            return torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        return p3.rfft3d(u.contiguous())

    def _bwd_kernel(self, fu, dealias):
        if dealias == "2/3-rule":
            fu = fu.masked_fill(~self._dealias_local(), 0)
        return p3.irfft3d(fu, self.real_shape())

    def _fwd_local(self, u, dealias):
        if self._kernel3d_ok():
            return self._fwd_kernel(u, dealias)
        x = fc.fft(fc.rfft2(u, axes=(-2, -1)), axis=-3)
        if dealias == "2/3-rule":
            x = x.masked_fill(~self._dealias_local(), 0)
        return x

    def _bwd_local(self, fu, dealias):
        if self._kernel3d_ok():
            return self._bwd_kernel(fu, dealias)
        if dealias == "2/3-rule":
            fu = fu.masked_fill(~self._dealias_local(), 0)
        x = fc.ifft(fu, axis=-3)
        return fc.irfft2(x, s=self.real_shape()[1:], axes=(-2, -1))

    # -- public transforms --------------------------------------------------------

    def forward_fn(self, dealias=None):
        """The raw forward, real (…, N0, N1, N2) -> complex (…, N0, N1, Nf)."""
        self._check_dealias(dealias)
        return lambda u: self._fwd_local(u, dealias)

    def backward_fn(self, dealias=None):
        self._check_dealias(dealias)
        return lambda fu: self._bwd_local(fu, dealias)

    def fftn(self, u, fu=None, dealias=None):
        """Forward 3D transform.  ``fu`` (reference out-param) is ignored."""
        u = self._coerce(u, self.float)
        return self._plan(("fftn", dealias), lambda: self.forward_fn(dealias))(u)

    def ifftn(self, fu, u=None, dealias=None):
        """Inverse 3D transform.  ``u`` (reference out-param) is ignored."""
        fu = self._coerce(fu, self.complex)
        return self._plan(("ifftn", dealias),
                          lambda: self.backward_fn(dealias))(fu)


class C2C:
    """Complex ↔ complex slab transform: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"slab.C2C: see {_ITEM_C2C}")


def _as_working(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as the reference's
    ``np.asarray(...).astype(FFT.float)`` constants are."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))
