"""Slab decomposition of 3D FFTs.

Port of ``mpifft4py_tpu/slab.py``: ``R2C`` and ``C2C`` over the shared
``_Slab3D``, at any P (the ranks of the transform's process group, see
``base.BaseFFT``).  The textbook slab pipeline:

    forward:  local z and y transforms → transpose → local x transform
    inverse:  local x inverse → transpose → local y and z inverses

Physical space is cut along axis 0 (this rank holds (N0/P, N1, N2)),
spectral space along axis 1 ((N0, N1/P, Nf)); the halved Hermitian axis is
never cut.  Scaling follows numpy: ``ifftn(fftn(u)) == u``.

``dealias="2/3-rule"`` masks the spectrum.  ``dealias="3/2-rule"`` (Orszag
padding, mpiFFT4py's ``padsize``) puts physical space on the padded grid
M = padsize·N (``work_shape``): the forward truncates M → N stage by stage
(so the transpose moves N-sized messages), folding the split Nyquist back
(and, for R2C, symmetrising the z-Nyquist plane to the exact alias sum),
and scales by 1/padsize³; the backward pads N → M and scales by padsize³.

Two routes, chosen by a pure predicate on precision and the transformed
grid (``_kernel_ok``, the counterpart of the reference's ``_pallas3d_ok``,
``_pallas_dist_ok`` and ``_pallas_dist_padded_ok``):

* the kernel path (float32, every axis of N — or of M under the 3/2 rule —
  in the kernels' envelope): the planar chains of ``ops.fft3d``, on the
  card the hand-written CUDA kernels, on the CPU their plain twins through
  the same glue.  The transpose moves planar float32 pairs; under
  ``communication="rdma"`` R2C's x stage is rows 24/25
  (``parallel.rdma``), every other transpose row 23;
* otherwise (``"double"``, other sizes) ``ops.fft_core`` over ``torch.fft``,
  as the reference falls back to ``jnp.fft``; its transposes move complex
  tensors, which ``"rdma"`` refuses (``ValueError``), as the reference's.

R2C's packed plane k2 = 0 carries X0 + i·X_Nyquist; separating the riders
needs conj(Q(−k0, −k1)) over the whole (k0, k1) plane, and k1 is cut, so
that plane (1/h of the field) is all-gathered.

The packed interface of R2C (``forward_packed_fn``/``backward_packed_fn``)
hands out the packed planar pair itself, with no complex boundary; its
envelope is the reference's (float32, ``(N2/2) % 128 == 0``, ``dealias``
None or "2/3-rule"), so both packages accept and refuse the same
configurations.  ``nl_forward_epilogue_fn`` is the packed solvers'
nonlinear forward at any P.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import BaseFFT, _as_working
from .ops import fft3d as p3
from .ops import fft_core as fc
from .parallel import rdma
from .parallel.mesh import check_divisible
from .utils import profiling
from .utils.spectral import (dealias_cutoffs, pad_full_axis, pad_half_axis,
                             trunc_full_axis, trunc_half_axis,
                             wavenumbers_full)
from .utils.transfer import device_put

__all__ = ["R2C", "C2C"]


class _PackedDist1D:
    """The packed planar pipeline of an R2C transform whose distributed
    choreography is ONE transpose: the slab always, the pencil when its
    second grid axis is degenerate (P2 == 1: the P2 transpose vanishes and
    what remains is the slab's, over the P1 group).  The counterpart of the
    reference's ``_PackedDist1D`` (``mpifft4py_tpu/slab.py``), a mixin over
    ``BaseFFT``: ``_pk_ride`` is the ``(ProcessGroup, PeerGroup | None)``
    pair its transpose and plane-0 gathers ride (the slab's whole group by
    default), ``_pk_cut`` the (parts, index) of this rank's k1 block of the
    packed pair.  Leading axes (component stacks) batch."""

    _has_packed = True

    @property
    def _pk_ride(self):
        return self.group, self._peers

    @property
    def _pk_cut(self):
        return self.P, self.rank

    @property
    def packed_z_perm(self):
        """lane → k2 map of the packed pair's last axis: always None, the
        natural 0..h−1 order (the reference's zdif lane order at N2 >= 512
        does not carry over)."""
        return None

    def _peer_kernels(self, t) -> bool:
        """Rows 24/25 carry the x stage: "rdma" at P > 1 on the card."""
        return self._pk_ride[1] is not None and t.device.type == "cuda"

    def _pair_fwd(self, u):
        """real (…, Np0, N1, N2) -> packed planar pair (…, N0, Np1, h), all
        three axes transformed: the packed z r2c and the y c2c, then the
        transpose and the x c2c — fused in row 24 under "rdma" (the y stage
        writes straight into this rank's symmetric buffer)."""
        u = u.contiguous()
        off = u.ndim - 3
        peers = self._pk_ride[1]
        yr, yi = p3.rfft_last_packed(u)
        if peers is not None:
            out = (peers.planes(yr.shape) if self._peer_kernels(u)
                   else None)
            yr, yi = p3.fft_axis_planar(yr, yi, off + 1, out=out)
            return rdma.fused_transpose_fft_x(yr, yi, peers)
        yr, yi = p3.fft_axis_planar(yr, yi, off + 1)
        return self._stage(
            (yr, yi), off + 1, off,
            lambda t: p3.fft_axis_planar(t[0].contiguous(),
                                         t[1].contiguous(), off),
            pipeline_axis=off + 2, ride=self._pk_ride)

    def _pair_bwd(self, pair):
        """packed planar pair (…, N0, Np1, h) -> real (…, Np0, N1, N2): the
        x inverse and the transpose (row 25 under "rdma"), then the y
        inverse and the packed z c2r.  Takes the pair as one tuple and
        drops it, so the input is freed once the x stage has run."""
        yr, yi = pair
        del pair
        off = yr.ndim - 3
        peers = self._pk_ride[1]
        if peers is not None:
            yr, yi = rdma.fused_ifft_x_transpose(yr.contiguous(),
                                                 yi.contiguous(), peers)
        else:
            yr, yi = self._stage(
                (yr, yi), off, off + 1, pipeline_axis=off + 2,
                pre_fn=lambda t: p3.fft_axis_planar(
                    t[0].contiguous(), t[1].contiguous(), off, inverse=True),
                ride=self._pk_ride)
        return p3.fused_zy_bwd(yr.contiguous(), yi.contiguous(),
                               int(self.N[2]))

    def _pk_flipconj(self, qr, qi):
        """conj(Q(−k0, −k1)) of a packed (…, N0, n1) plane, k1 cut as the
        packed pair's."""
        return self._flipconj_plane(qr, qi, self._pk_ride, self._pk_cut)

    def _unpack(self, yr, yi):
        """packed pair (…, N0, n1, h) -> complex (…, N0, n1, h + 1): the
        plane-0 riders separated over the gathered (k0, k1) plane."""
        with profiling.span("mpifft.transform.boundary"):
            qr, qi = yr[..., 0], yi[..., 0]
            cr, ci = self._pk_flipconj(qr, qi)
            p0 = torch.complex(0.5 * (qr + cr), 0.5 * (qi + ci))
            pny = torch.complex(0.5 * (qi - ci), -0.5 * (qr - cr))
            body = torch.complex(yr[..., 1:], yi[..., 1:])
            return torch.cat([p0[..., None], body, pny[..., None]], dim=-1)

    def _purify(self, yr, yi):
        """Drop the Nyquist rider from packed plane 0 in place (→ X0
        exactly): ``ops.fft3d.purify_plane0_dus`` over the gathered
        plane."""
        qr, qi = yr[..., 0], yi[..., 0]
        cr, ci = self._pk_flipconj(qr, qi)
        qr.copy_(0.5 * (qr + cr))
        qi.copy_(0.5 * (qi + ci))
        return yr, yi

    def _packed_mask_local(self, h):
        """2/3-rule mask (N0, n1, h) over this rank's packed block (k2 =
        0..h−1), built once."""
        if getattr(self, "_pk_mask", None) is None:
            c = dealias_cutoffs(self.N)
            s0, s1, _ = self.local_spectral_slices("packed")
            k0, k1 = (torch.from_numpy(wavenumbers_full(int(n))[s]).to(
                self.device) for n, s in zip(self.N[:2], (s0, s1)))
            k2 = torch.arange(h, device=self.device)
            self._pk_mask = ((k0.abs()[:, None, None] < c[0])
                             & (k1.abs()[None, :, None] < c[1])
                             & (k2[None, None, :] < c[2]))
        return self._pk_mask

    def forward_packed_fn(self, dealias=None):
        """real (…, n0, n1, N2) -> this rank's block of the packed planar
        pair (…, N0, N1/parts, N2/2), no complex boundary.  Plane k2 = 0
        carries X0 + i·X_Nyquist; with the 2/3 rule the rider is purified
        away and the pair is the masked spectrum on k2 = 0..h−1.  Leading
        dims batch."""
        self._packed_gate_is_serial(dealias)

        def fwd(u):
            with profiling.span("mpifft.transform.forward"):
                return self._fwd_packed(u, dealias)
        return fwd

    def _fwd_packed(self, u, dealias):
        yr, yi = self._pair_fwd(u)
        if dealias == "2/3-rule":
            self._purify(yr, yi)
            keep = self._packed_mask_local(yr.shape[-1])
            yr, yi = yr.masked_fill(~keep, 0), yi.masked_fill(~keep, 0)
        return yr, yi

    def backward_packed_fn(self, dealias=None):
        """Inverse of ``forward_packed_fn`` (same envelope): a pair (or a
        (2, …) tensor) -> real (…, n0, n1, N2)."""
        self._packed_gate_is_serial(dealias)

        def bwd(pair):
            with profiling.span("mpifft.transform.backward"):
                yr, yi = pair
                if dealias == "2/3-rule":
                    keep = self._packed_mask_local(yr.shape[-1])
                    yr, yi = (yr.masked_fill(~keep, 0),
                              yi.masked_fill(~keep, 0))
                return self._pair_bwd((yr, yi))
        return bwd

    # -- the complex interface over the packed pipeline ------------------------------

    def _fwd_packed_complex(self, u, dealias):
        if dealias == "2/3-rule":
            # mask in the packed planar domain (the packed forward: purify
            # the Nyquist rider, mask the pair), emit a zero Nyquist column
            yr, yi = self._fwd_packed(u, dealias)
            with profiling.span("mpifft.transform.boundary"):
                x = torch.complex(yr, yi)
                del yr, yi          # freed before the cat allocates
                return torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        return self._unpack(*self._pair_fwd(u))

    def _bwd_packed_complex(self, fu, dealias):
        if dealias == "2/3-rule":
            fu = self._masked(fu)
        return self._pair_bwd(p3.pack_spectrum(fu))

    # -- the packed solvers' nonlinear forward -----------------------------------------

    def _nl_pair(self, phys, op):
        """The nonlinear forward's product under the z and y forwards and
        the transpose: a pair (…, N0, n1, h), x pending (rows 12/15's
        kernel, then row 1, then the transpose: row 23 under "rdma")."""
        if op == "mul":
            fzr, fzi = p3.mul_rfft_zy_packed(*phys)
        else:
            fzr, fzi = p3.cross_rfft_zy_packed(*phys)
        return self._stage((fzr, fzi), 2, 1, pipeline_axis=3,
                           ride=self._pk_ride)

    def nl_forward_epilogue_fn(self, mode: str, visc: float, op: str = "cross",
                               ri=None, dealias="2/3-rule"):
        """The packed solvers' whole nonlinear forward at any P: the product
        with the packed z r2c and the y c2c (``_nl_pair``), the transpose,
        the x c2c with the mask, the ``mode`` epilogue and −visc·k²·S on
        this rank's k1/m1 block (row 14), then the plane-0 purify over the
        gathered plane.  Returns a function

            (A, B[, C, D][, Tr, Ti], Sr, Si, k0, k1, k2, m0, m1, m2) -> d

        with A/B/C/D this rank's physical 3-stacks (B a (1, …) field for
        op="mul"), (Sr, Si) the packed state (a 3-stack, a 1-stack for mode
        "div"), (Tr, Ti) the buoyancy rider (``ri`` set), and the GLOBAL
        1-D wavenumber/mask vectors (k1/m1 are cut here).  ``d`` is a
        (2, ns, N0, n1, h) tensor whose [0]/[1] are the increment's re/im
        planes."""
        if not self._nl_dist_ok(dealias):
            raise ValueError("nl_forward_epilogue_fn needs the packed "
                             "interface's envelope and dealias='2/3-rule'")
        if op not in ("cross", "cross2", "mul"):
            raise ValueError(f"op must be 'cross', 'cross2' or 'mul', got "
                             f"{op!r}")
        nphys = 4 if op == "cross2" else 2
        blk = self.local_spectral_slices("packed")[1]

        def fn(*xs):
            phys, xs = xs[:nphys], xs[nphys:]
            buoy = None
            if ri is not None:
                buoy, xs = (xs[0], xs[1], ri), xs[2:]
            sr, si, k0, k1, k2, m0, m1, m2 = xs
            fzr, fzi = self._nl_pair(phys, op)
            d = p3.fft_x_epilogue_packed(
                fzr.contiguous(), fzi.contiguous(), sr, si, k0, k1[blk], k2,
                m0, m1[blk], m2, mode, visc, buoy=buoy)
            self._purify(d[0], d[1])
            return d
        return fn


class _Slab3D(BaseFFT):
    """Shared slab machinery; subclasses fix the last axis (half or full),
    its kernel route and its ``torch.fft`` stages."""

    ndim = 3

    def _validate(self):
        check_divisible(self.N[0], self.P, "slab real axis 0")
        check_divisible(self.N[1], self.P, "slab spectral axis 1")
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

    # -- shapes (reference-parity helpers; "local" = this rank's block) -----

    def real_shape(self):
        return (int(self.N[0]) // self.P, int(self.N[1]), int(self.N[2]))

    def complex_shape(self):
        return (int(self.N[0]), int(self.N[1]) // self.P, self._lastf)

    def complex_shape_T(self):
        """Transposed (pre-Alltoall) spectral shape."""
        return (int(self.N[0]) // self.P, int(self.N[1]), self._lastf)

    def complex_shape_I(self):
        """Alltoall send-view shape (P, Np0, Np1, lastf)."""
        return (self.P, int(self.N[0]) // self.P, int(self.N[1]) // self.P,
                self._lastf)

    def global_real_shape(self):
        return tuple(int(n) for n in self.N)

    def global_complex_shape(self):
        return (int(self.N[0]), int(self.N[1]), self._lastf)

    def real_shape_padded(self):
        return (int(self.M[0]) // self.P, int(self.M[1]), int(self.M[2]))

    def global_real_shape_padded(self):
        return tuple(int(m) for m in self.M)

    def work_shape(self, dealias=None):
        """Physical-space (fftn input / ifftn output) local shape."""
        return self.real_shape_padded() if dealias == "3/2-rule" \
            else self.real_shape()

    def global_work_shape(self, dealias=None):
        return self.global_real_shape_padded() if dealias == "3/2-rule" \
            else self.global_real_shape()

    def real_local_slice(self, rank: int = 0, padsize: float = 1.0):
        Np0 = int(round(padsize * self.N[0])) // self.P
        N = [int(round(padsize * n)) for n in self.N]
        return (slice(rank * Np0, (rank + 1) * Np0), slice(0, N[1]),
                slice(0, N[2]))

    def complex_local_slice(self, rank: int = 0):
        Np1 = int(self.N[1]) // self.P
        return (slice(0, int(self.N[0])), slice(rank * Np1, (rank + 1) * Np1),
                slice(0, self._lastf))

    # -- wavenumber and coordinate meshes, built on the device ---------------

    def _k_local(self, dtype):
        """Spectral wavenumbers (k0, k1, k2) for the local layout (N0, Np1,
        lastf): k1 is this rank's block, k2 in fft layout for the full
        (C2C) last axis."""
        def full(n):
            j = torch.arange(n, device=self.device)
            return torch.where(j < n // 2, j, j - n).to(dtype)
        N0, N1, N2 = (int(n) for n in self.N)
        k2 = (full(N2) if self._lastf == N2
              else torch.arange(self._lastf, device=self.device).to(dtype))
        return full(N0), full(N1)[self.local_spectral_slices()[1]], k2

    def get_local_wavenumbermesh(self) -> torch.Tensor:
        """(3,) + complex_shape() integer wavenumbers (this rank's)."""
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
        with profiling.span("mpifft.transform.forward"):
            if not self._kernel_ok(dealias):
                return self._fwd_torch(u, dealias)
            if dealias == "3/2-rule":
                return self._fwd_padded_kernel(u)
            return self._fwd_kernel(u, dealias)

    def _bwd_local(self, fu, dealias):
        with profiling.span("mpifft.transform.backward"):
            if not self._kernel_ok(dealias):
                return self._bwd_torch(fu, dealias)
            if dealias == "3/2-rule":
                return self._bwd_padded_kernel(fu)
            return self._bwd_kernel(fu, dealias)

    # -- the 3/2 rule's kernel chain (the reference's
    #    ``_fwd_dist_pallas_padded``/``_bwd_dist_pallas_padded``);
    #    subclasses supply the last-axis stage ------------------------------

    def _last_fwd_padded(self, u):
        raise NotImplementedError

    def _last_bwd_padded(self, yr, yi):
        raise NotImplementedError

    def _fwd_padded_kernel(self, u):
        """(…, Mp0, M1, M2) -> (…, N0, Np1, lastf): the last-axis stage at
        M2 with its truncation and 1/padsize³ folded in, the y c2c at M1
        then the truncation to N1, the transpose, the x c2c at M0 then the
        truncation to N0, then ``_sym_nyq``; each stage runs at the widths
        the previous truncation left, and the transpose moves N-sized
        messages."""
        N0, N1 = int(self.N[0]), int(self.N[1])
        yr, yi = self._last_fwd_padded(u)
        ax = yr.ndim - 3
        yr, yi = p3.fft_axis_planar(yr, yi, ax + 1)
        with profiling.span("mpifft.transform.boundary"):
            yr, yi = (trunc_full_axis(a, -2, N1).contiguous()
                      for a in (yr, yi))

        def x_stage(t):
            ar, ai = p3.fft_axis_planar(t[0].contiguous(), t[1].contiguous(),
                                        ax)
            with profiling.span("mpifft.transform.boundary"):
                return (trunc_full_axis(ar, -3, N0),
                        trunc_full_axis(ai, -3, N0))
        yr, yi = self._stage((yr, yi), ax + 1, ax, x_stage,
                             pipeline_axis=ax + 2)
        with profiling.span("mpifft.transform.boundary"):
            return self._sym_nyq(torch.complex(yr, yi))

    def _bwd_padded_kernel(self, fu):
        """(…, N0, Np1, lastf) -> (…, Mp0, M1, M2), the mirror: pad x to M0
        and run the x inverse, the transpose, pad y to M1 and run the y
        inverse, then the last-axis stage with its pad to M2 and padsize³
        folded in."""
        M0, M1 = int(self.M[0]), int(self.M[1])
        ax = fu.ndim - 3

        def x_stage(t):
            with profiling.span("mpifft.transform.boundary"):
                ar, ai = (pad_full_axis(a, -3, M0).contiguous() for a in t)
            return p3.fft_axis_planar(ar, ai, ax, inverse=True)
        yr, yi = self._stage((fu.real, fu.imag), ax, ax + 1,
                             pipeline_axis=ax + 2, pre_fn=x_stage)
        with profiling.span("mpifft.transform.boundary"):
            yr, yi = (pad_full_axis(a, -2, M1).contiguous()
                      for a in (yr, yi))
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
        ax = x.ndim - 3
        if dealias == "3/2-rule":
            N0 = int(self.N[0])
            x = self._trunc_last(trunc_full_axis(x, -2, int(self.N[1])))
            x = self._stage(x, ax + 1, ax, lambda y: trunc_full_axis(
                fc.fft(y, axis=-3), -3, N0), pipeline_axis=ax + 2)
            return self._sym_nyq(x) * (1.0 / self.padsize ** 3)
        x = self._stage(x, ax + 1, ax, lambda y: fc.fft(y, axis=-3),
                        pipeline_axis=ax + 2)
        return self._masked(x) if dealias == "2/3-rule" else x

    def _bwd_torch(self, fu, dealias):
        ax = fu.ndim - 3
        if dealias == "2/3-rule":
            fu = self._masked(fu)
        if dealias == "3/2-rule":
            M0 = int(self.M[0])
            x = self._stage(fu, ax, ax + 1, pipeline_axis=ax + 2,
                            pre_fn=lambda y: fc.ifft(
                                pad_full_axis(y, -3, M0), axis=-3))
            x = self._pad_last(pad_full_axis(x, -2, int(self.M[1])))
            return self._ifft_yz(x, self.real_shape_padded()) \
                * self.padsize ** 3
        x = self._stage(fu, ax, ax + 1, pipeline_axis=ax + 2,
                        pre_fn=lambda y: fc.ifft(y, axis=-3))
        return self._ifft_yz(x, self.real_shape())

    def _check_padded(self, dealias):
        self._check_dealias(dealias)
        if dealias == "3/2-rule":
            check_divisible(self.M[0], self.P, "slab padded axis 0")

    # -- public transforms --------------------------------------------------------

    def forward_fn(self, dealias=None):
        """The raw forward of this rank's block, (…,) + work_shape(dealias)
        -> (…,) + complex_shape(); leading axes batch.  At P > 1 every rank
        of the group calls it together."""
        self._check_padded(dealias)
        return lambda u: self._fwd_local(u, dealias)

    def backward_fn(self, dealias=None):
        self._check_padded(dealias)
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


class R2C(_PackedDist1D, _Slab3D):
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

    # -- the packed interface's gates (the pipeline: ``_PackedDist1D``) --------------

    def _packed_iface_ok(self, dealias) -> bool:
        """The reference's envelope of the packed interface, on the port's
        kernel path: float32, every axis in the kernels' envelope,
        (N2/2) % 128 == 0, ``dealias`` None or "2/3-rule"."""
        return (dealias in (None, "2/3-rule") and self._kernel3d_ok()
                and (int(self.N[2]) // 2) % 128 == 0)

    def _packed_gate_is_serial(self, dealias) -> bool:
        """Entry gate of the packed interface: raises outside the envelope;
        True where the serial chain serves it (P == 1), False where the
        pair crosses the transpose."""
        if not self._packed_iface_ok(dealias):
            raise ValueError(
                "packed interface needs a float32 R2C with every axis in the "
                "kernels' envelope, (N2/2) % 128 == 0, and dealias in "
                "(None, '2/3-rule')")
        return self.P == 1

    def _nl_dist_ok(self, dealias) -> bool:
        """Gate of ``nl_forward_epilogue_fn``: the packed envelope, the 2/3
        rule, and the x-epilogue kernel's N0."""
        return (dealias == "2/3-rule" and self._packed_iface_ok(dealias)
                and p3.fft_x_epilogue_ok(int(self.N[0])))

    # -- the kernel path ---------------------------------------------------------

    def _fwd_kernel(self, u, dealias):
        return self._fwd_packed_complex(u, dealias)

    def _bwd_kernel(self, fu, dealias):
        return self._bwd_packed_complex(fu, dealias)

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
        q + conj(q(−k0, −k1)) (the reference's ``_sym_nyq``; k1 is cut, so
        the plane is gathered as a planar pair).  ``x`` is the forward's
        own tensor."""
        q = x[..., -1]
        fr, fi = self._flipconj_plane(q.real, q.imag, None,
                                      (self.P, self.rank))
        q.copy_(0.5 * (q + torch.complex(fr, fi)))
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
        """This rank's block of a global (complex) physical-space array."""
        return device_put(self._cut(u, "real"), self.complex, self.device)

    def _kernel_ok(self, dealias) -> bool:
        """float32 and every axis of the transformed grid (M under the 3/2
        rule) in the kernels' envelope; a pure predicate."""
        dims = self.M if dealias == "3/2-rule" else self.N
        return (self.float == torch.float32
                and all(p3.supported_c2c(int(n)) for n in dims))

    def _fwd_kernel(self, u, dealias):
        """The last-axis c2c, the y c2c, the transpose and the x c2c (the
        reference's ``_fwd_dist_pallas``; ``ops.fft3d.cfft3d`` at P == 1)."""
        ax = u.ndim - 3
        with profiling.span("mpifft.transform.boundary"):
            ur, ui = u.real.contiguous(), u.imag.contiguous()
        yr, yi = p3.fft_last_planar_c2c(ur, ui)
        del ur, ui
        yr, yi = p3.fft_axis_planar(yr, yi, ax + 1)
        pair = self._stage(
            (yr, yi), ax + 1, ax,
            lambda t: p3.fft_axis_planar(t[0].contiguous(),
                                         t[1].contiguous(), ax),
            pipeline_axis=ax + 2)
        with profiling.span("mpifft.transform.boundary"):
            x = torch.complex(*pair)
        del pair
        return self._masked(x) if dealias == "2/3-rule" else x

    def _bwd_kernel(self, fu, dealias):
        if dealias == "2/3-rule":
            fu = self._masked(fu)
        ax = fu.ndim - 3
        yr, yi = self._stage(
            (fu.real, fu.imag), ax, ax + 1, pipeline_axis=ax + 2,
            pre_fn=lambda t: p3.fft_axis_planar(
                t[0].contiguous(), t[1].contiguous(), ax, inverse=True))
        yr, yi = p3.fft_axis_planar(yr.contiguous(), yi.contiguous(), ax + 1,
                                    inverse=True)
        pair = p3.fft_last_planar_c2c(yr, yi, inverse=True)
        with profiling.span("mpifft.transform.boundary"):
            return torch.complex(*pair)

    def _last_fwd_padded(self, u):
        """The z c2c at M2 with 1/padsize³ folded in, then the truncation
        to N2 (row 10)."""
        with profiling.span("mpifft.transform.boundary"):
            ur, ui = u.real.contiguous(), u.imag.contiguous()
        yr, yi = p3.fft_last_planar_c2c(ur, ui, scale=1.0 / self.padsize ** 3)
        del ur, ui
        N2 = int(self.N[2])
        with profiling.span("mpifft.transform.boundary"):
            return tuple(trunc_full_axis(a, -1, N2).contiguous()
                         for a in (yr, yi))

    def _last_bwd_padded(self, yr, yi):
        """The pad to M2, then the z inverse c2c with padsize³ folded in."""
        M2 = int(self.M[2])
        with profiling.span("mpifft.transform.boundary"):
            yr, yi = (pad_full_axis(a, -1, M2).contiguous() for a in (yr, yi))
        pair = p3.fft_last_planar_c2c(yr, yi, inverse=True,
                                      scale=self.padsize ** 3)
        with profiling.span("mpifft.transform.boundary"):
            return torch.complex(*pair)

    # -- the torch.fft route -----------------------------------------------------

    def _fft_yz(self, u):
        return fc.fft2(u, axes=(-2, -1))

    def _ifft_yz(self, x, s):
        return fc.ifft2(x, axes=(-2, -1))

    def _trunc_last(self, x):
        return trunc_full_axis(x, -1, int(self.N[2]))

    def _pad_last(self, x):
        return pad_full_axis(x, -1, int(self.M[2]))
