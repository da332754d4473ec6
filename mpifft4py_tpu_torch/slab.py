"""Slab decomposition of 3D FFTs, on one device.

Port of ``mpifft4py_tpu/slab.py`` at P == 1 (the slab's single-device fast
path): ``R2C`` and ``C2C`` over the shared ``_Slab3D``, as the reference's
``_Slab3D`` serves both.  Scaling follows numpy: ``ifftn(fftn(u)) == u``.

``dealias="2/3-rule"`` masks the spectrum.  ``dealias="3/2-rule"`` (Orszag
padding, mpiFFT4py's ``padsize``) puts physical space on the padded grid
M = padsize·N (``work_shape``): the forward truncates M → N, folding the
split Nyquist back (and, for R2C, symmetrising the z-Nyquist plane to the
exact alias sum), and scales by 1/padsize³; the backward pads N → M and
scales by padsize³.

Two routes, chosen by a pure predicate on precision and the transformed
grid (``_kernel_ok``, the counterpart of the reference's ``_pallas3d_ok``
and ``_pallas_dist_padded_ok``):

* the kernel path (float32, every axis of N — or of M under the 3/2 rule —
  in the kernels' envelope): the planar chains of ``ops.fft3d``, on the
  card the hand-written CUDA kernels, on the CPU their plain twins through
  the same glue;
* otherwise (``"double"``, other sizes) ``ops.fft_core`` over ``torch.fft``,
  as the reference falls back to ``jnp.fft``.

The packed interface of R2C (``forward_packed_fn``/``backward_packed_fn``)
hands out the packed planar pair itself, with no complex boundary; its
envelope is the reference's (float32, ``(N2/2) % 128 == 0``, ``dealias``
None or "2/3-rule"), so both packages accept and refuse the same
configurations.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import BaseFFT, _as_working
from .ops import fft3d as p3
from .ops import fft_core as fc
from .utils.spectral import (dealias_cutoffs, flip_conj_plane, pad_full_axis,
                             pad_half_axis, trunc_full_axis, trunc_half_axis)
from .utils.transfer import device_put

__all__ = ["R2C", "C2C"]


class _Slab3D(BaseFFT):
    """Shared slab machinery; subclasses fix the last axis (half or full),
    its kernel route and its ``torch.fft`` stages."""

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

    # spectral length of the last axis; R2C overrides with N2//2 + 1
    @property
    def _lastf(self) -> int:
        return int(self.N[2])

    @property
    def _in_dtype(self) -> torch.dtype:
        return self.complex

    # -- shapes (reference-parity helpers; local == global at P == 1) -------

    def real_shape(self):
        return tuple(int(n) for n in self.N)

    def complex_shape(self):
        return (int(self.N[0]), int(self.N[1]), self._lastf)

    def complex_shape_T(self):
        """Transposed (pre-Alltoall) spectral shape."""
        return self.complex_shape()

    def complex_shape_I(self):
        """Alltoall send-view shape (P, Np0, Np1, lastf)."""
        return (1,) + self.complex_shape()

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
                slice(0, self._lastf))

    # -- wavenumber and coordinate meshes, built on the device ---------------

    def _k_local(self, dtype):
        """Spectral wavenumbers (k0, k1, k2) for the layout (N0, N1, lastf):
        k2 is in fft layout for the full (C2C) last axis."""
        def full(n):
            j = torch.arange(n, device=self.device)
            return torch.where(j < n // 2, j, j - n).to(dtype)
        N0, N1, N2 = (int(n) for n in self.N)
        k2 = (full(N2) if self._lastf == N2
              else torch.arange(self._lastf, device=self.device).to(dtype))
        return full(N0), full(N1), k2

    def get_local_wavenumbermesh(self) -> torch.Tensor:
        """(3,) + complex_shape() integer wavenumbers."""
        return torch.stack(torch.meshgrid(*self._k_local(self.float),
                                          indexing="ij"))

    def get_scaled_local_wavenumbermesh(self) -> torch.Tensor:
        """Physical wavenumbers k_i·2π/L_i."""
        scale = 2 * np.pi / self.L
        k = [ki * _as_working(s, self.float)
             for ki, s in zip(self._k_local(self.float), scale)]
        return torch.stack(torch.meshgrid(*k, indexing="ij"))

    def get_dealias_filter(self) -> torch.Tensor:
        """2/3-rule boolean mask of complex_shape()."""
        return self._dealias_local()

    def _dealias_local(self) -> torch.Tensor:
        if self._mask is None:
            c = dealias_cutoffs(self.N)
            k0, k1, k2 = self._k_local(torch.float32)
            self._mask = ((k0.abs()[:, None, None] < c[0])
                          & (k1.abs()[None, :, None] < c[1])
                          & (k2.abs()[None, None, :] < c[2]))
        return self._mask

    def _masked(self, x):
        return x.masked_fill(~self._dealias_local(), 0)

    # -- routes ------------------------------------------------------------------

    def _kernel_ok(self, dealias) -> bool:
        raise NotImplementedError

    def _fwd_local(self, u, dealias):
        if not self._kernel_ok(dealias):
            return self._fwd_torch(u, dealias)
        if dealias == "3/2-rule":
            return self._fwd_padded_kernel(u)
        return self._fwd_kernel(u, dealias)

    def _bwd_local(self, fu, dealias):
        if not self._kernel_ok(dealias):
            return self._bwd_torch(fu, dealias)
        if dealias == "3/2-rule":
            return self._bwd_padded_kernel(fu)
        return self._bwd_kernel(fu, dealias)

    # -- the 3/2 rule's kernel chain (the P == 1 form of the reference's
    #    ``_fwd_dist_pallas_padded``/``_bwd_dist_pallas_padded``); subclasses
    #    supply the last-axis stage ----------------------------------------

    def _last_fwd_padded(self, u):
        raise NotImplementedError

    def _last_bwd_padded(self, yr, yi):
        raise NotImplementedError

    def _fwd_padded_kernel(self, u):
        """(…, M0, M1, M2) -> (…, N0, N1, lastf): the last-axis stage at M2
        with its truncation and 1/padsize³ folded in, the y c2c at M1 then
        the truncation to N1, the x c2c at M0 then to N0, then
        ``_sym_nyq``; each stage runs at the widths the previous truncation
        left."""
        N0, N1 = int(self.N[0]), int(self.N[1])
        yr, yi = self._last_fwd_padded(u)
        ax = yr.ndim - 2
        yr, yi = p3.fft_axis_planar(yr, yi, ax)
        yr, yi = (trunc_full_axis(a, -2, N1).contiguous() for a in (yr, yi))
        yr, yi = p3.fft_axis_planar(yr, yi, ax - 1)
        x = torch.complex(trunc_full_axis(yr, -3, N0),
                          trunc_full_axis(yi, -3, N0))
        return self._sym_nyq(x)

    def _bwd_padded_kernel(self, fu):
        """(…, N0, N1, lastf) -> (…, M0, M1, M2), the mirror: pad x to M0
        and run the x inverse, pad y to M1 and run the y inverse, then the
        last-axis stage with its pad to M2 and padsize³ folded in."""
        M0, M1 = int(self.M[0]), int(self.M[1])
        ax = fu.ndim - 3
        yr, yi = (pad_full_axis(a, -3, M0).contiguous()
                  for a in (fu.real, fu.imag))
        yr, yi = p3.fft_axis_planar(yr, yi, ax, inverse=True)
        yr, yi = (pad_full_axis(a, -2, M1).contiguous() for a in (yr, yi))
        yr, yi = p3.fft_axis_planar(yr, yi, ax + 1, inverse=True)
        return self._last_bwd_padded(yr, yi)

    # the torch.fft route (the reference's XLA tier): subclass hooks
    def _fft_yz(self, u):
        raise NotImplementedError

    def _ifft_yz(self, x, s):
        raise NotImplementedError

    def _trunc_last(self, x):
        raise NotImplementedError

    def _pad_last(self, x):
        raise NotImplementedError

    def _sym_nyq(self, x):
        """The forward's last step under the 3/2 rule: R2C symmetrises its
        z-Nyquist plane; a full (C2C) last axis has none to fix."""
        return x

    def _fwd_torch(self, u, dealias):
        x = self._fft_yz(u)                                   # (…, W0, W1, ·)
        if dealias == "3/2-rule":
            x = self._trunc_last(trunc_full_axis(x, -2, int(self.N[1])))
            x = trunc_full_axis(fc.fft(x, axis=-3), -3, int(self.N[0]))
            return self._sym_nyq(x) * (1.0 / self.padsize ** 3)
        x = fc.fft(x, axis=-3)
        return self._masked(x) if dealias == "2/3-rule" else x

    def _bwd_torch(self, fu, dealias):
        if dealias == "2/3-rule":
            fu = self._masked(fu)
        if dealias == "3/2-rule":
            x = fc.ifft(pad_full_axis(fu, -3, int(self.M[0])), axis=-3)
            x = self._pad_last(pad_full_axis(x, -2, int(self.M[1])))
            return self._ifft_yz(x, self.real_shape_padded()) \
                * self.padsize ** 3
        return self._ifft_yz(fc.ifft(fu, axis=-3), self.real_shape())

    # -- public transforms --------------------------------------------------------

    def forward_fn(self, dealias=None):
        """The raw forward, (…,) + work_shape(dealias) -> (…,) +
        complex_shape(); leading axes batch."""
        self._check_dealias(dealias)
        return lambda u: self._fwd_local(u, dealias)

    def backward_fn(self, dealias=None):
        self._check_dealias(dealias)
        return lambda fu: self._bwd_local(fu, dealias)

    def fftn(self, u, fu=None, dealias=None):
        """Forward 3D transform.  ``fu`` (reference out-param) is ignored."""
        u = self._coerce(u, self._in_dtype)
        return self._plan(("fftn", dealias), lambda: self.forward_fn(dealias))(u)

    def ifftn(self, fu, u=None, dealias=None):
        """Inverse 3D transform.  ``u`` (reference out-param) is ignored."""
        fu = self._coerce(fu, self.complex)
        return self._plan(("ifftn", dealias),
                          lambda: self.backward_fn(dealias))(fu)


class R2C(_Slab3D):
    """Real ↔ complex 3D transform.

    Physical space: real (N0, N1, N2), or (M0, M1, M2) under the 3/2 rule.
    Spectral space: complex (N0, N1, Nf = N2//2 + 1).  Transforms act on the
    last three axes, so a stack of fields (C, N0, N1, N2) transforms in one
    call.
    """

    @property
    def _lastf(self) -> int:
        return int(self.N[2]) // 2 + 1

    @property
    def _in_dtype(self) -> torch.dtype:
        return self.float

    @property
    def Nf(self) -> int:
        return self._lastf

    # -- routes ------------------------------------------------------------------

    def _kernel3d_ok(self) -> bool:
        """The hand-written kernel path: float32 and every axis in the
        reference's envelope (``supported_c2c`` N0, N1: n = r·m, m <= 128
        the largest divisor, r <= 8, m >= 8; ``supported_r2c`` N2: even,
        16..2048), all of which the kernels serve.  A pure predicate: the
        CPU takes the same glue through the kernels' plain twins."""
        return (self.float == torch.float32
                and p3.supported_r2c_grid(self.N))

    def _padded_kernel_ok(self) -> bool:
        """The 3/2 rule's kernel path: float32 and every padded length M in
        the kernels' envelope (the reference's ``_pallas_dist_padded_ok``,
        which it takes first, even at P == 1)."""
        return self.float == torch.float32 and p3.supported_r2c_grid(self.M)

    def _kernel_ok(self, dealias) -> bool:
        return (self._padded_kernel_ok() if dealias == "3/2-rule"
                else self._kernel3d_ok())

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

    # -- the kernel path ---------------------------------------------------------

    def _fwd_kernel(self, u, dealias):
        if dealias == "2/3-rule":
            # mask in the packed planar domain (the packed forward: purify
            # the Nyquist rider, mask the pair), emit a zero Nyquist column
            x = torch.complex(*self._fwd_packed(u, dealias))
            return torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        return p3.rfft3d(u.contiguous())

    def _bwd_kernel(self, fu, dealias):
        if dealias == "2/3-rule":
            fu = self._masked(fu)
        return p3.irfft3d(fu, self.real_shape())

    def _last_fwd_padded(self, u):
        """The z r2c at M2 into Nf columns, the truncation's Nyquist ×2 and
        1/padsize³ folded in (row 8)."""
        return p3.rfft_last_planar(u.contiguous(), nf=self._lastf,
                                   scale=1.0 / self.padsize ** 3)

    def _last_bwd_padded(self, yr, yi):
        """The z c2r from Nf columns to M2, the pad's halved Nyquist and
        padsize³ folded in (row 9)."""
        return p3.irfft_last_planar(yr, yi, int(self.M[2]), nf_in=self._lastf,
                                    scale=self.padsize ** 3)

    def _sym_nyq(self, x):
        """Hermitian-symmetrise the z-Nyquist plane of a padded forward, in
        place: the truncation doubled it, the exact alias sum is
        q + conj(q(−k0, −k1)) (the reference's ``_sym_nyq`` at P == 1).
        ``x`` is the forward's own tensor."""
        q = x[..., -1]
        q.copy_(0.5 * (q + flip_conj_plane(q, (-2, -1))))
        return x

    # -- the torch.fft route -----------------------------------------------------

    def _fft_yz(self, u):
        return fc.rfft2(u, axes=(-2, -1))

    def _ifft_yz(self, x, s):
        return fc.irfft2(x, s=s[1:], axes=(-2, -1))

    def _trunc_last(self, x):
        return trunc_half_axis(x, -1, self._lastf)

    def _pad_last(self, x):
        return pad_half_axis(x, -1, int(self.M[2]) // 2 + 1)


class C2C(_Slab3D):
    """Complex ↔ complex 3D transform.

    Both spaces are complex (N0, N1, N2), physical space (M0, M1, M2) under
    the 3/2 rule; the last axis is full, with k2 in fft layout.  The kernel
    path is ``ops.fft3d.cfft3d`` (the last-axis c2c, then ``fft_axis`` on y
    and x); under the 3/2 rule it is R2C's padded chain with the last-axis
    c2c as its z stage.
    """

    def shard_real(self, u) -> torch.Tensor:
        """A host array as a (complex) physical-space field on the device."""
        return device_put(u, self.complex, self.device)

    def _kernel_ok(self, dealias) -> bool:
        """float32 and every axis of the transformed grid (M under the 3/2
        rule) in the kernels' envelope; a pure predicate."""
        dims = self.M if dealias == "3/2-rule" else self.N
        return (self.float == torch.float32
                and all(p3.supported_c2c(int(n)) for n in dims))

    def _fwd_kernel(self, u, dealias):
        x = p3.cfft3d(u)
        return self._masked(x) if dealias == "2/3-rule" else x

    def _bwd_kernel(self, fu, dealias):
        if dealias == "2/3-rule":
            fu = self._masked(fu)
        return p3.cfft3d(fu, inverse=True)

    def _last_fwd_padded(self, u):
        """The z c2c at M2 with 1/padsize³ folded in, then the truncation
        to N2 (row 10)."""
        yr, yi = p3.fft_last_planar_c2c(u.real.contiguous(),
                                        u.imag.contiguous(),
                                        scale=1.0 / self.padsize ** 3)
        N2 = int(self.N[2])
        return tuple(trunc_full_axis(a, -1, N2).contiguous()
                     for a in (yr, yi))

    def _last_bwd_padded(self, yr, yi):
        """The pad to M2, then the z inverse c2c with padsize³ folded in."""
        M2 = int(self.M[2])
        yr, yi = (pad_full_axis(a, -1, M2).contiguous() for a in (yr, yi))
        return torch.complex(*p3.fft_last_planar_c2c(
            yr, yi, inverse=True, scale=self.padsize ** 3))

    # -- the torch.fft route -----------------------------------------------------

    def _fft_yz(self, u):
        return fc.fft2(u, axes=(-2, -1))

    def _ifft_yz(self, x, s):
        return fc.ifft2(x, axes=(-2, -1))

    def _trunc_last(self, x):
        return trunc_full_axis(x, -1, int(self.N[2]))

    def _pad_last(self, x):
        return pad_full_axis(x, -1, int(self.M[2]))
