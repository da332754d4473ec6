"""Pencil (2-D) decomposition of 3D FFTs.

Port of ``mpifft4py_tpu/pencil.py``: ``R2C`` and ``C2C`` on a P1×P2 grid
of ranks (``parallel.mesh.pencil_groups``: rank = r1·P2 + r2; the P1
group is this rank's column of the grid, the P2 group its row).  The
textbook pencil pipeline:

    forward:  local z transform → transpose over P2 → local y transform
              → transpose over P1 → local x transform
    inverse:  the mirror image.

Layouts (global shapes; ``alignment="X"``, the reference's default):

    physical: real    (N0, N1, N2)   this rank (N0/P1, N1/P2, N2)
    spectral: complex (N0, N1, Nfp)  this rank (N0, N1/P1, Nfp/P2)

The pencil cuts the halved Hermitian axis (Nf = N2//2 + 1, odd), so it is
padded to Nfp = ⌈Nf/P2⌉·P2 with structural zero modes k2 >= Nf (removed by
every dealias mask, dropped before the z inverse).  ``alignment="Y"``
transposes z → x → y and holds (N0/P2, N1, Nfp/P1), Nfp = ⌈Nf/P1⌉·P1.
``C2C`` keeps the full last axis and needs P2 | N2 (X) or P1 | N2 (Y).

Routes, chosen by pure predicates on precision and the grid:

* the packed pipeline at P2 == 1 (R2C, alignment X, (N2/2) % 128 == 0,
  not the 3/2 rule): the P2 transpose vanishes and what remains is the
  slab's, over the P1 group (``slab._PackedDist1D``);
* the planar kernel path (float32, every axis of N, or of M under the 3/2
  rule, in the kernels' envelope): the z stage is row 8 (the r2c into Nf
  columns and zeros up to Nfp; row 10 for C2C), the y stage row 1 after
  the P2 transpose — under ``communication="rdma"`` (X, unpadded) row 26,
  which receives and transforms in one kernel, the z stage writing
  straight into its symmetric buffer — and the x stage row 1 after the P1
  transpose, or row 24; the inverse mirrors it with rows 25, 27 and 9.
  Alignment Y and the 3/2 rule ride the generic stages (row 23 under
  "rdma"), as in the reference;
* otherwise (``"double"``, other sizes) ``ops.fft_core`` over
  ``torch.fft``; its transposes move complex tensors, which ``"rdma"``
  refuses (``ValueError``), as the reference's.

The packed interface (``forward_packed_fn``/``backward_packed_fn``,
``nl_forward_epilogue_fn``) is the slab's at P2 == 1 over the P1 group,
and the reference's WIDE choreography at P2 > 1: the packed pair keeps its
h = N2/2 lanes whole and the rows are cut,

    physical (N0/P1, N1/P2, N2) → z (rows 4/5) → (N0/P1, N1/P2, h)
    → transpose over P2 (split x, concat y), y → (N0/P, N1, h)
    → transpose over the joint P1×P2 group (split y, concat x), x
    → (N0, N1/P, h),

with k1 cut over P = P1·P2 (needs P | N0 and P | N1).  The reference's
joint stage rides XLA's all-to-all under "rdma", because its kernels
address one mesh axis; the port's row 23 takes any group, so under "rdma"
the joint stage (and the plane-0 gather over the joint group) is row 23
over the whole group.  On one card that is the only choice: gloo moves no
CUDA tensor.  The doubleword (``*_dd``) methods are not ported: the card
has native float64.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import BaseFFT, _as_working
from .ops import fft3d as p3
from .ops import fft_core as fc
from .parallel import rdma
from .parallel.mesh import check_divisible, pencil_comm
from .slab import _PackedDist1D
from .utils import profiling
from .utils.spectral import (dealias_cutoffs, pad_full_axis, pad_half_axis,
                             trunc_full_axis, trunc_half_axis,
                             wavenumbers_full)
from .utils.transfer import device_put

__all__ = ["R2C", "C2C"]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class _Pencil3D(_PackedDist1D, BaseFFT):
    """Shared pencil machinery; subclasses fix the last-axis transform
    (R2C: the halved Hermitian axis padded to Nfp; C2C: the full axis)."""

    ndim = 3
    _is_r2c = True

    def __init__(self, N, L, comm=None, precision: str = "single", *,
                 P1=None, alignment: str = "X", **kw):
        if alignment not in ("X", "Y"):
            raise ValueError(f"alignment must be 'X' or 'Y', got "
                             f"{alignment!r}")
        self.alignment = alignment
        self._P1_req = P1
        super().__init__(N, L, comm, precision, **kw)

    def _resolve_comm(self, comm):
        """The grid's group (rank r1·P2 + r2) and its sub-groups."""
        group, g1, g2, self.P1, self.P2, self.r1, self.r2 = pencil_comm(
            comm, self._P1_req)
        self._ride1, self._ride2 = (g1, None), (g2, None)
        return group, self.P1 * self.P2, self.r1 * self.P2 + self.r2

    def _validate(self):
        N = [int(n) for n in self.N]
        check_divisible(N[0], self.P1, "pencil real axis 0 (P1)")
        check_divisible(N[1], self.P2, "pencil real axis 1 (P2)")
        check_divisible(N[1], self.P1, "pencil spectral axis 1 (P1)")
        for n in N:
            if n % 2:
                raise ValueError(f"grid sizes must be even, got {tuple(N)}")
        M = self.padsize * self.N
        if not np.allclose(M, np.round(M)):
            raise ValueError(f"padsize*N must be integral, got {M}")
        self.M = np.round(M).astype(np.int64)
        if self._is_r2c:
            self.Nf, self.Mf = N[2] // 2 + 1, int(self.M[2]) // 2 + 1
        else:
            self.Nf, self.Mf = N[2], int(self.M[2])
        if self.alignment == "Y":
            check_divisible(N[0], self.P2, "pencil Y spectral axis 0 (P2)")
            self.Nfp = _cdiv(self.Nf, self.P1) * self.P1
        else:
            self.Nfp = _cdiv(self.Nf, self.P2) * self.P2
        if not self._is_r2c and self.Nfp != self.Nf:
            ax, p = (("P1", self.P1) if self.alignment == "Y"
                     else ("P2", self.P2))
            raise ValueError(f"pencil C2C needs {ax} | N2 (got N2={self.Nf}, "
                             f"{ax}={p})")
        self._mask = None
        if self.communication == "rdma":
            # a PeerGroup per sub-group: its symmetric buffers are
            # exchanged within that sub-group only; a sub-group that spans
            # the grid is the whole group and rides its PeerGroup
            self._ride1, self._ride2 = (
                (g, None) if g is None else
                (g, self._peers) if g is self.group else
                (g, rdma.PeerGroup(g, p, r, self.device))
                for g, p, r in ((self._ride1[0], self.P1, self.r1),
                                (self._ride2[0], self.P2, self.r2)))

    # -- shapes (reference parity; "local" = this rank's block) ----------------

    def real_shape(self):
        return (int(self.N[0]) // self.P1, int(self.N[1]) // self.P2,
                int(self.N[2]))

    def complex_shape(self):
        if self.alignment == "Y":
            return (int(self.N[0]) // self.P2, int(self.N[1]),
                    self.Nfp // self.P1)
        return (int(self.N[0]), int(self.N[1]) // self.P1,
                self.Nfp // self.P2)

    def global_real_shape(self):
        return tuple(int(n) for n in self.N)

    def global_complex_shape(self):
        return (int(self.N[0]), int(self.N[1]), self.Nfp)

    def real_shape_padded(self):
        return (int(self.M[0]) // self.P1, int(self.M[1]) // self.P2,
                int(self.M[2]))

    def global_real_shape_padded(self):
        return tuple(int(m) for m in self.M)

    def work_shape(self, dealias=None):
        return self.real_shape_padded() if dealias == "3/2-rule" \
            else self.real_shape()

    def global_work_shape(self, dealias=None):
        return self.global_real_shape_padded() if dealias == "3/2-rule" \
            else self.global_real_shape()

    def real_local_slice(self, coords=(0, 0), padsize: float = 1.0):
        r1, r2 = coords
        n0 = int(round(padsize * self.N[0])) // self.P1
        n1 = int(round(padsize * self.N[1])) // self.P2
        return (slice(r1 * n0, (r1 + 1) * n0), slice(r2 * n1, (r2 + 1) * n1),
                slice(0, int(round(padsize * self.N[2]))))

    def complex_local_slice(self, coords=(0, 0)):
        r1, r2 = coords
        if self.alignment == "Y":
            n0 = int(self.N[0]) // self.P2
            nf = self.Nfp // self.P1
            return (slice(r2 * n0, (r2 + 1) * n0), slice(0, int(self.N[1])),
                    slice(r1 * nf, (r1 + 1) * nf))
        n1 = int(self.N[1]) // self.P1
        nf = self.Nfp // self.P2
        return (slice(0, int(self.N[0])), slice(r1 * n1, (r1 + 1) * n1),
                slice(r2 * nf, (r2 + 1) * nf))

    # -- the block map -------------------------------------------------------------

    def _cuts(self, kind: str, rank: int):
        r1, r2 = divmod(rank, self.P2)
        if kind == "real":
            return {0: (self.P1, r1), 1: (self.P2, r2)}
        if kind == "packed":
            return {1: self._pk_cut_of(rank)}
        if self.alignment == "Y":
            return {0: (self.P2, r2), 2: (self.P1, r1)}
        return {1: (self.P1, r1), 2: (self.P2, r2)}

    def _pk_cut_of(self, rank: int):
        """k1 of the packed pair: cut over P1 at P2 == 1, over P (WIDE)."""
        return (self.P1, rank // self.P2) if self.P2 == 1 else (self.P, rank)

    @property
    def _pk_ride(self):
        return self._ride1 if self.P2 == 1 else (self.group, self._peers)

    @property
    def _pk_cut(self):
        return self._pk_cut_of(self.rank)

    # -- wavenumber and coordinate meshes, built on the device ---------------------

    def _k2_global(self):
        """The last axis' wavenumbers over its Nfp lanes (R2C: 0..Nfp−1,
        the lanes >= Nf structural zeros)."""
        return np.arange(self.Nfp, dtype=np.float64)

    def _k_local(self, dtype):
        """This rank's (k0, k1, k2) of the complex layout."""
        ks = (wavenumbers_full(int(self.N[0])),
              wavenumbers_full(int(self.N[1])), self._k2_global())
        return tuple(torch.from_numpy(np.ascontiguousarray(k[s])).to(
            device=self.device, dtype=dtype)
            for k, s in zip(ks, self.local_spectral_slices("complex")))

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

    # -- routes ------------------------------------------------------------------------

    def _grid_ok(self, dims) -> bool:
        raise NotImplementedError

    def _kernel_ok(self, dealias) -> bool:
        """The planar kernel path: float32, P2 <= 128 and every axis of the
        transformed grid (M under the 3/2 rule) in the kernels' envelope
        (the reference's ``_pallas_dist_ok`` without its TPU gate)."""
        dims = self.M if dealias == "3/2-rule" else self.N
        return (self.float == torch.float32 and self.P2 <= 128
                and self._grid_ok(dims))

    def _packed_dist_ok(self, dealias) -> bool:
        """P2 == 1: the slab's packed pipeline over the P1 group (X only:
        it produces the slab's spectral layout)."""
        return (self._is_r2c and self.P2 == 1 and self.alignment == "X"
                and dealias != "3/2-rule"
                and (int(self.N[2]) // 2) % 128 == 0
                and self._kernel_ok(dealias))

    def _packed_wide_ok(self, dealias) -> bool:
        """P2 > 1: the WIDE choreography (P | N0 and P | N1)."""
        return (self._is_r2c and self.P2 > 1 and dealias != "3/2-rule"
                and (int(self.N[2]) // 2) % 128 == 0
                and self._kernel_ok(dealias)
                and int(self.N[0]) % self.P == 0
                and int(self.N[1]) % self.P == 0)

    def _packed_iface_ok(self, dealias) -> bool:
        return self._packed_dist_ok(dealias) or self._packed_wide_ok(dealias)

    def _packed_gate_is_serial(self, dealias) -> bool:
        """Entry gate of the packed interface: raises outside the envelope;
        True at P == 1."""
        if not self._packed_iface_ok(dealias):
            raise ValueError(
                "packed interface needs a float32 pencil R2C with every axis "
                "in the kernels' envelope, (N2/2) % 128 == 0, dealias in "
                "(None, '2/3-rule'), and P2 == 1 with alignment 'X' or "
                "P2 > 1 with P1·P2 | N0 and P1·P2 | N1")
        return self.P == 1

    def _nl_dist_ok(self, dealias) -> bool:
        return (dealias == "2/3-rule" and self._packed_iface_ok(dealias)
                and p3.fft_x_epilogue_ok(int(self.N[0])))

    def _fwd_local(self, u, dealias):
        with profiling.span("mpifft.transform.forward"):
            if self._packed_dist_ok(dealias):
                return self._fwd_packed_complex(u, dealias)
            if self._kernel_ok(dealias):
                return self._fwd_planar(u, dealias)
            return self._fwd_torch(u, dealias)

    def _bwd_local(self, fu, dealias):
        with profiling.span("mpifft.transform.backward"):
            if self._packed_dist_ok(dealias):
                return self._bwd_packed_complex(fu, dealias)
            if self._kernel_ok(dealias):
                return self._bwd_planar(fu, dealias)
            return self._bwd_torch(fu, dealias)

    # -- the packed WIDE choreography (P2 > 1) ---------------------------------------

    def _pair_fwd(self, u):
        """real (…, n0, n1, N2) -> packed pair (…, N0, N1/P, h): at P2 == 1
        the slab's pipeline over the P1 group; at P2 > 1 the z r2c (row 4),
        the P2 transpose (split x, concat y) with the y c2c, the joint
        transpose (split y, concat x) with the x c2c."""
        if self.P2 == 1:
            return super()._pair_fwd(u)
        u = u.contiguous()
        off = u.ndim - 3
        pair = self._stage(p3.rfft_last_packed(u), off, off + 1,
                           _fft(off + 1), pipeline_axis=off + 2,
                           ride=self._ride2)
        return self._stage(pair, off + 1, off, _fft(off),
                           pipeline_axis=off + 2)

    def _pair_bwd(self, pair):
        if self.P2 == 1:
            return super()._pair_bwd(pair)
        yr, yi = pair
        del pair
        off = yr.ndim - 3
        pair = self._stage((yr, yi), off, off + 1, pipeline_axis=off + 2,
                           pre_fn=_fft(off, inverse=True))
        yr, yi = self._stage(pair, off + 1, off, pipeline_axis=off + 2,
                             pre_fn=_fft(off + 1, inverse=True),
                             ride=self._ride2)
        return p3.irfft_last_packed(yr.contiguous(), yi.contiguous(),
                                    int(self.N[2]))

    def _nl_pair(self, phys, op):
        """WIDE: y is cut in physical space, so only the z r2c fuses with
        the product (row 16's function: rows 12/15's z kernel, the port's
        ``ops.fft3d.cross_rfft_z``/``mul_rfft_z``); y runs after the P2
        transpose, and x waits for the joint one (the epilogue kernel
        transforms it)."""
        if self.P2 == 1:
            return super()._nl_pair(phys, op)
        fz = (p3.mul_rfft_z(*phys) if op == "mul"
              else p3.cross_rfft_z(*phys))
        pair = self._stage(fz, 1, 2, _fft(2), pipeline_axis=3,
                           ride=self._ride2)
        return self._stage(pair, 2, 1, pipeline_axis=3)

    # -- the planar kernel path (the reference's ``_fwd_dist_planar``) --------------

    def _peer_path(self, ride, padded):
        """The peers of rows 24-27 for a stage over ``ride``: "rdma", X,
        unpadded, a group of more than one (on the CPU the same group-level
        functions run their twins)."""
        if (self.communication != "rdma" or self.alignment != "X" or padded
                or ride[0] is None):
            return None
        return ride[1]

    def _fwd_planar(self, u, dealias):
        padded = dealias == "3/2-rule"
        N0, N1 = int(self.N[0]), int(self.N[1])
        u = u.contiguous()
        off = u.ndim - 3
        ypeers = self._peer_path(self._ride2, padded)
        xpeers = self._peer_path(self._ride1, padded)
        cuda = u.device.type == "cuda"
        out = (ypeers.planes(u.shape[:-1] + (self.Nfp,))
               if ypeers is not None and cuda else None)
        yr, yi = self._z_fwd(u, padded, out)

        def fftw(axis, n):
            if not padded:
                return _fft(axis)
            return lambda t: tuple(trunc_full_axis(a, axis, n)
                                   for a in _fft(axis)(t))

        if self.alignment == "Y":
            pair = self._stage((yr, yi), off + 2, off, fftw(off, N0),
                               pipeline_axis=off + 1, ride=self._ride1)
            pair = self._stage(pair, off, off + 1, fftw(off + 1, N1),
                               pipeline_axis=off + 2, ride=self._ride2)
        else:
            if ypeers is not None:
                # row 26, its output straight into row 24's buffer
                xo = None
                if xpeers is not None and cuda:
                    xo = xpeers.planes(
                        u.shape[:-3] + (u.shape[-3], N1,
                                        self.Nfp // self.P2))
                pair = rdma.fused_transpose_fft_y(yr, yi, ypeers, out=xo)
            else:
                pair = self._stage((yr, yi), off + 2, off + 1,
                                   fftw(off + 1, N1), pipeline_axis=off,
                                   ride=self._ride2)
            if xpeers is not None:
                pair = rdma.fused_transpose_fft_x(pair[0].contiguous(),
                                                  pair[1].contiguous(),
                                                  xpeers)
            else:
                pair = self._stage(pair, off + 1, off, fftw(off, N0),
                                   pipeline_axis=off + 2, ride=self._ride1)
        x = torch.complex(pair[0], pair[1])
        if padded:
            return self._fix_nyq(x)     # 1/padsize³ folded into the z stage
        return self._masked(x) if dealias == "2/3-rule" else x

    def _bwd_planar(self, fu, dealias):
        padded = dealias == "3/2-rule"
        M0, M1 = int(self.M[0]), int(self.M[1])
        if dealias == "2/3-rule":
            fu = self._masked(fu)
        off = fu.ndim - 3
        ypeers = self._peer_path(self._ride2, padded)
        xpeers = self._peer_path(self._ride1, padded)
        pr, pi = fu.real.contiguous(), fu.imag.contiguous()
        del fu

        def ifftw(axis, m):
            def w(t):
                if padded:
                    t = tuple(pad_full_axis(a, axis, m) for a in t)
                return _fft(axis, inverse=True)(t)
            return w

        if self.alignment == "Y":
            pair = self._stage((pr, pi), off + 1, off, pipeline_axis=off + 2,
                               pre_fn=ifftw(off + 1, M1), ride=self._ride2)
            pair = self._stage(pair, off, off + 2, pipeline_axis=off + 1,
                               pre_fn=ifftw(off, M0), ride=self._ride1)
        else:
            if xpeers is not None:
                pair = rdma.fused_ifft_x_transpose(pr, pi, xpeers)
            else:
                pair = self._stage((pr, pi), off, off + 1,
                                   pipeline_axis=off + 2,
                                   pre_fn=ifftw(off, M0), ride=self._ride1)
            del pr, pi
            if ypeers is not None:
                pair = rdma.fused_ifft_y_transpose(pair[0].contiguous(),
                                                   pair[1].contiguous(),
                                                   ypeers)
            else:
                pair = self._stage(pair, off + 1, off + 2, pipeline_axis=off,
                                   pre_fn=ifftw(off + 1, M1),
                                   ride=self._ride2)
        return self._z_bwd(pair[0].contiguous(), pair[1].contiguous(),
                           padded)

    def _z_fwd(self, u, padded, out):
        raise NotImplementedError

    def _z_bwd(self, pr, pi, padded):
        raise NotImplementedError

    def _fix_nyq(self, x):
        return x

    # -- the torch.fft route (the reference's XLA tier) ------------------------------

    def _fft_last(self, u):
        raise NotImplementedError

    def _ifft_last(self, x, padded):
        raise NotImplementedError

    def _trunc_last(self, x):
        raise NotImplementedError

    def _pad_last(self, x):
        raise NotImplementedError

    def _align_pad2(self, x):
        if x.shape[-1] == self.Nfp:
            return x
        return torch.cat([x, x.new_zeros(x.shape[:-1]
                                         + (self.Nfp - x.shape[-1],))], -1)

    def _fwd_torch(self, u, dealias):
        padded = dealias == "3/2-rule"
        N0, N1 = int(self.N[0]), int(self.N[1])
        off = u.ndim - 3
        x = self._fft_last(u)
        if padded:
            x = self._trunc_last(x)
        x = self._align_pad2(x)

        def fft_t(axis, n):
            if padded:
                return lambda y: trunc_full_axis(fc.fft(y, axis=axis), axis, n)
            return lambda y: fc.fft(y, axis=axis)

        if self.alignment == "Y":
            x = self._stage(x, off + 2, off, fft_t(off, N0),
                            pipeline_axis=off + 1, ride=self._ride1)
            x = self._stage(x, off, off + 1, fft_t(off + 1, N1),
                            pipeline_axis=off + 2, ride=self._ride2)
        else:
            x = self._stage(x, off + 2, off + 1, fft_t(off + 1, N1),
                            pipeline_axis=off, ride=self._ride2)
            x = self._stage(x, off + 1, off, fft_t(off, N0),
                            pipeline_axis=off + 2, ride=self._ride1)
        if padded:
            return self._fix_nyq(x) * (1.0 / self.padsize ** 3)
        return self._masked(x) if dealias == "2/3-rule" else x

    def _bwd_torch(self, fu, dealias):
        padded = dealias == "3/2-rule"
        M0, M1 = int(self.M[0]), int(self.M[1])
        off = fu.ndim - 3
        if dealias == "2/3-rule":
            fu = self._masked(fu)

        def ifft_p(axis, m):
            if padded:
                return lambda y: fc.ifft(pad_full_axis(y, axis, m), axis=axis)
            return lambda y: fc.ifft(y, axis=axis)

        if self.alignment == "Y":
            x = self._stage(fu, off + 1, off, pipeline_axis=off + 2,
                            pre_fn=ifft_p(off + 1, M1), ride=self._ride2)
            x = self._stage(x, off, off + 2, pipeline_axis=off + 1,
                            pre_fn=ifft_p(off, M0), ride=self._ride1)
        else:
            x = self._stage(fu, off, off + 1, pipeline_axis=off + 2,
                            pre_fn=ifft_p(off, M0), ride=self._ride1)
            x = self._stage(x, off + 1, off + 2, pipeline_axis=off,
                            pre_fn=ifft_p(off + 1, M1), ride=self._ride2)
        x = x[..., :self.Nf]                  # drop the alignment padding
        if padded:
            return self._ifft_last(self._pad_last(x), True) \
                * self.padsize ** 3
        return self._ifft_last(x, False)

    # -- public transforms -----------------------------------------------------------

    def _check_padded(self, dealias):
        self._check_dealias(dealias)
        if dealias == "3/2-rule":
            check_divisible(self.M[0], self.P1, "pencil padded axis 0 (P1)")
            check_divisible(self.M[1], self.P2, "pencil padded axis 1 (P2)")

    def forward_fn(self, dealias=None):
        """The raw forward of this rank's block, (…,) + work_shape(dealias)
        -> (…,) + complex_shape(); leading axes batch.  At P > 1 every rank
        of the grid calls it together."""
        self._check_padded(dealias)
        return lambda u: self._fwd_local(u, dealias)

    def backward_fn(self, dealias=None):
        self._check_padded(dealias)
        return lambda fu: self._bwd_local(fu, dealias)

    def fftn(self, u, fu=None, dealias=None):
        """Forward 3D transform.  ``fu`` (reference out-param) is ignored."""
        u = self._coerce(u, self._in_dtype)
        return self._plan(("fftn", dealias),
                          lambda: self.forward_fn(dealias))(u)

    def ifftn(self, fu, u=None, dealias=None):
        """Inverse 3D transform.  ``u`` (reference out-param) is ignored."""
        fu = self._coerce(fu, self.complex)
        return self._plan(("ifftn", dealias),
                          lambda: self.backward_fn(dealias))(fu)


def _fft(axis, inverse=False):
    """The c2c along ``axis`` of a planar pair (row 1), as a stage's work."""
    return lambda t: p3.fft_axis_planar(t[0].contiguous(), t[1].contiguous(),
                                        axis, inverse=inverse)


class R2C(_Pencil3D):
    """Real ↔ complex 3D pencil transform.

    Physical space: real (N0, N1, N2), or (M0, M1, M2) under the 3/2 rule,
    this rank's (N0/P1, N1/P2, N2).  Spectral space: complex (N0, N1, Nfp)
    with Nf = N2//2 + 1 live columns.  Transforms act on the last three
    axes, so a stack of fields transforms in one call.
    """

    _is_r2c = True

    @property
    def _in_dtype(self) -> torch.dtype:
        return self.float

    def _grid_ok(self, dims) -> bool:
        return p3.supported_r2c_grid(dims)

    def _z_fwd(self, u, padded, out):
        """Row 8: the z r2c into Nf columns and zeros up to Nfp, the 3/2
        rule's truncation and 1/padsize³ folded in; into ``out`` (row 26's
        symmetric buffer) when given."""
        return p3.rfft_last_planar(
            u, nf=self.Nf, scale=1.0 / self.padsize ** 3 if padded else 1.0,
            width=self.Nfp, out=out)

    def _z_bwd(self, pr, pi, padded):
        """Row 9 from the first Nf of the Nfp columns (the pad to M2 and
        padsize³ folded in under the 3/2 rule)."""
        if padded:
            return p3.irfft_last_planar(pr, pi, int(self.M[2]),
                                        nf_in=self.Nf,
                                        scale=self.padsize ** 3)
        return p3.irfft_last_planar(pr, pi, int(self.N[2]), nf_in=self.Nf)

    def _fix_nyq(self, x):
        """Hermitian-symmetrise the z-Nyquist plane of a padded forward, in
        place (see ``slab.R2C._sym_nyq``).  The Hermitian axis is cut here,
        so only the ranks whose block holds k2 = Nf−1 fix it; the plane's
        flip spans one whole axis and one cut axis, so that plane is
        gathered over the cut axis' group (the P1 group for X, P2 for Y),
        whose ranks all hold the same k2 block."""
        if self.alignment == "Y":
            chunk, herm = self.Nfp // self.P1, self.r1
            ride, cut, axis = self._ride2, (self.P2, self.r2), -2
        else:
            chunk, herm = self.Nfp // self.P2, self.r2
            ride, cut, axis = self._ride1, (self.P1, self.r1), -1
        rank_ny, off = divmod(self.Nf - 1, chunk)
        if herm != rank_ny:
            return x
        q = x[..., off]
        fr, fi = self._flipconj_plane(q.real, q.imag, ride, cut, axis)
        q.copy_(0.5 * (q + torch.complex(fr, fi)))
        return x

    def _fft_last(self, u):
        return fc.rfft(u, axis=-1)

    def _ifft_last(self, x, padded):
        n = int(self.M[2] if padded else self.N[2])
        return fc.irfft(x, axis=-1, n=n)

    def _trunc_last(self, x):
        return trunc_half_axis(x, -1, self.Nf)

    def _pad_last(self, x):
        return pad_half_axis(x, -1, self.Mf)


class C2C(_Pencil3D):
    """Complex ↔ complex 3D pencil transform.

    Both spaces are complex (N0, N1, N2); the full last axis (k2 in fft
    layout) is cut by divisibility, with no alignment padding (P2 | N2,
    or P1 | N2 for alignment "Y").  The kernel path's z stage is row 10.
    """

    _is_r2c = False
    _has_packed = False

    @property
    def _in_dtype(self) -> torch.dtype:
        return self.complex

    def _grid_ok(self, dims) -> bool:
        return all(p3.supported_c2c(int(n)) for n in dims)

    def _k2_global(self):
        return wavenumbers_full(int(self.N[2]))

    def shard_real(self, u) -> torch.Tensor:
        """This rank's block of a global (complex) physical-space array."""
        return device_put(self._cut(u, "real"), self.complex, self.device)

    def _packed_iface_ok(self, dealias) -> bool:
        return False        # the packed layout is an R2C concept

    def _z_fwd(self, u, padded, out):
        """Row 10 (with 1/padsize³ and the truncation to N2 under the 3/2
        rule)."""
        yr, yi = p3.fft_last_planar_c2c(
            u.real.contiguous(), u.imag.contiguous(),
            scale=1.0 / self.padsize ** 3 if padded else 1.0)
        if padded:
            N2 = int(self.N[2])
            yr, yi = (trunc_full_axis(a, -1, N2).contiguous()
                      for a in (yr, yi))
        return yr, yi

    def _z_bwd(self, pr, pi, padded):
        if padded:
            M2 = int(self.M[2])
            pr, pi = (pad_full_axis(a, -1, M2).contiguous() for a in (pr, pi))
        return torch.complex(*p3.fft_last_planar_c2c(
            pr, pi, inverse=True,
            scale=self.padsize ** 3 if padded else 1.0))

    def _fft_last(self, u):
        return fc.fft(u, axis=-1)

    def _ifft_last(self, x, padded):
        return fc.ifft(x, axis=-1)

    def _trunc_last(self, x):
        return trunc_full_axis(x, -1, int(self.N[2]))

    def _pad_last(self, x):
        return pad_full_axis(x, -1, int(self.M[2]))
