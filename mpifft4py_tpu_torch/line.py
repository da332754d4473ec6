"""Line (1D) decomposition of 2D FFTs, on one device.

Port of ``mpifft4py_tpu/line.py`` ``R2C`` at P == 1:

    forward:  rfft along axis 1, then fft along axis 0
    inverse:  ifft along axis 0, then irfft along axis 1

Physical space is real (N0, N1) (the padded (M0, M1) under the 3/2 rule),
spectral space complex (N0, Nfp).  ``Nfp`` is the reference's alignment
padding of Nf = N1//2 + 1 to a multiple of P, so Nfp == Nf here.  The
transforms act on the last two axes: a stack (C, N0, N1) transforms in
one call.

At P == 1 the reference's ``_stage`` is its work function, and its default
route is ``fft_core`` over ``jnp.fft`` (its Pallas serial-2D tier sits
behind ``MPIFFT4PY_TPU_PALLAS2D``, a knob that is not ported), so the port
runs ``ops/fft_core.py`` over ``torch.fft`` in both precisions ("double"
is native fp64: the doubleword methods are not ported).  The packed 2D
layout of ``models.NavierStokes2D`` does not go through this class's
transforms: it calls the hand-written kernels of ``ops.fft3d`` directly.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import BaseFFT, _as_working
from .ops import fft_core as fc
from .utils.spectral import (dealias_cutoffs, flip_conj_plane, pad_full_axis,
                             pad_half_axis, trunc_full_axis, trunc_half_axis)

__all__ = ["R2C"]


class R2C(BaseFFT):
    """Real ↔ complex 2D line transform (reference: mpiFFT4py/line.py R2C)."""

    ndim = 2

    def _validate(self):
        if self.P > 1:
            raise NotImplementedError(
                f"line.R2C at P = {self.P}: the 2D line decomposition is "
                f"ported at P == 1 only (ROADMAP.md queue 1 item 5)")
        for n in self.N:
            if n % 2:
                raise ValueError(f"grid sizes must be even, got {tuple(self.N)}")
        M = self.padsize * self.N
        if not np.allclose(M, np.round(M)):
            raise ValueError(f"padsize*N must be integral, got {M}")
        self.M = np.round(M).astype(np.int64)
        self.Nf = int(self.N[1]) // 2 + 1
        self.Nfp = self.Nf                  # ceil(Nf / P)·P at P == 1
        self.Mf = int(self.M[1]) // 2 + 1
        self.Mfp = self.Mf
        self._mask = None

    # -- shapes ---------------------------------------------------------------

    def real_shape(self):
        return (int(self.N[0]), int(self.N[1]))

    def complex_shape(self):
        return (int(self.N[0]), self.Nfp)

    def global_real_shape(self):
        return self.real_shape()

    def global_complex_shape(self):
        return self.complex_shape()

    def real_shape_padded(self):
        return (int(self.M[0]), int(self.M[1]))

    def global_real_shape_padded(self):
        return self.real_shape_padded()

    def work_shape(self, dealias=None):
        return (self.real_shape_padded() if dealias == "3/2-rule"
                else self.real_shape())

    def real_local_slice(self, rank: int = 0, padsize: float = 1.0):
        Np0 = int(round(padsize * self.N[0]))
        return (slice(rank * Np0, (rank + 1) * Np0),
                slice(0, int(round(padsize * self.N[1]))))

    def complex_local_slice(self, rank: int = 0):
        return (slice(0, int(self.N[0])),
                slice(rank * self.Nfp, (rank + 1) * self.Nfp))

    # -- meshes and masks, built on the device --------------------------------

    def _k_local(self, dtype):
        """(k0, k1): k0 in fft layout, k1 = 0..Nfp−1 (rfft layout)."""
        N0 = int(self.N[0])
        j = torch.arange(N0, device=self.device)
        k0 = torch.where(j < N0 // 2, j, j - N0).to(dtype)
        k1 = torch.arange(self.Nfp, device=self.device).to(dtype)
        return k0, k1

    def get_local_wavenumbermesh(self) -> torch.Tensor:
        """(2, N0, Nfp) integer wavenumbers."""
        return torch.stack(torch.meshgrid(*self._k_local(self.float),
                                          indexing="ij"))

    def get_scaled_local_wavenumbermesh(self) -> torch.Tensor:
        """Physical wavenumbers k_i·2π/L_i, (2, N0, Nfp)."""
        s = (2 * np.pi / self.L).astype(np.float64)
        k = [ki * _as_working(si, self.float)
             for ki, si in zip(self._k_local(self.float), s)]
        return torch.stack(torch.meshgrid(*k, indexing="ij"))

    def get_dealias_filter(self) -> torch.Tensor:
        """2/3-rule boolean mask of complex_shape()."""
        return self._dealias_local()

    def _dealias_local(self) -> torch.Tensor:
        if self._mask is None:
            c = dealias_cutoffs(self.N)
            k0, k1 = self._k_local(torch.float32)
            self._mask = ((k0.abs()[:, None] < c[0])
                          & (k1.abs()[None, :] < c[1]))
        return self._mask

    # -- the transforms ---------------------------------------------------------

    def _fwd_local(self, u, dealias):
        x = fc.rfft(u, axis=-1)                          # (…, W0, W1//2+1)
        if dealias == "3/2-rule":
            x = trunc_half_axis(x, -1, self.Nf)
            x = trunc_full_axis(fc.fft(x, axis=-2), -2, int(self.N[0]))
            return self._sym_nyq(x) * (1.0 / self.padsize ** 2)
        x = fc.fft(x, axis=-2)
        if dealias == "2/3-rule":
            x = x.masked_fill(~self._dealias_local(), 0)
        return x

    def _sym_nyq(self, x):
        """Hermitian-symmetrise the y-Nyquist column of a padded forward, in
        place: ``trunc_half_axis`` doubled it, the exact alias sum is
        q + conj(q(−k0)).  ``x`` is the forward's own tensor."""
        q = x[..., self.Nf - 1]
        q.copy_(0.5 * (q + flip_conj_plane(q, (-1,))))
        return x

    def _bwd_local(self, fu, dealias):
        if dealias == "2/3-rule":
            fu = fu.masked_fill(~self._dealias_local(), 0)
        if dealias == "3/2-rule":
            x = fc.ifft(pad_full_axis(fu, -2, int(self.M[0])), axis=-2)
            x = pad_half_axis(x[..., :self.Nf], -1, self.Mf)
            u = fc.irfft(x, n=int(self.M[1]), axis=-1)
            return (u * self.padsize ** 2).to(self.float)
        x = fc.ifft(fu, axis=-2)[..., :self.Nf]
        return fc.irfft(x, n=int(self.N[1]), axis=-1).to(self.float)

    def forward_fn(self, dealias=None):
        """The raw forward, (…,) + work_shape(dealias) -> (…,) +
        complex_shape(); leading axes batch."""
        self._check_dealias(dealias)
        return lambda u: self._fwd_local(u, dealias)

    def backward_fn(self, dealias=None):
        self._check_dealias(dealias)
        return lambda fu: self._bwd_local(fu, dealias)

    def fft2(self, u, fu=None, dealias=None):
        """Forward 2D transform (reference line.R2C.fft2); ``fu`` (the
        reference's out-param) is ignored."""
        u = self._coerce(u, self.float)
        return self._plan(("fft2", dealias), lambda: self.forward_fn(dealias))(u)

    def ifft2(self, fu, u=None, dealias=None):
        """Inverse 2D transform (reference line.R2C.ifft2); ``u`` is
        ignored."""
        fu = self._coerce(fu, self.complex)
        return self._plan(("ifft2", dealias),
                          lambda: self.backward_fn(dealias))(fu)

