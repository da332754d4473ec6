"""Plain NS3D over a slab of P ranks: ``reference/ns3d.py``'s equations
(rotational form, the 2/3 rule, classic RK4, one component a transform)
with each rank holding its block, as mpiFFT4py's slab cuts the fields:
physical space along x, (N0/P, N1, N2); spectral space along k1, (N0,
N1/P, N2/2 + 1).  The transforms are written out over the group:

    forward:  rfft2 over (y, z) -> all-to-all (k1 blocks to their ranks)
              -> fft over x, then the 2/3-rule mask
    inverse:  ifft over x -> all-to-all (x blocks to their ranks)
              -> irfft2 over (y, z)

``torch.fft`` along the local axes and ``dist.all_to_all_single`` for the
transpose (complex blocks as float pairs, which every backend moves).  The
energy is summed over the group.  ``packed_to_complex`` converts the
program's packed state, whose plane k2 = 0 carries X0 + i·X_Nyq, with the
flip-conjugate of that plane gathered from every rank.  With
``precision="tf32"`` (the control) every local transform's input is
rounded to TF32.  Nothing here imports the program, JAX or the JAX
package.
"""

import math

import torch
import torch.distributed as dist

from .ns3d import NS3D, TWO_THIRDS, flipconj


def group_size_rank(group):
    """(P, rank) of ``group``; None is a world of one."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _pairs(t):
    return torch.view_as_real(t) if t.is_complex() else t


def all_to_all(x, group, split, concat):
    """Block d of ``x`` along ``split`` to rank d; the blocks received
    from ranks 0..P−1 concatenated along ``concat`` in rank order."""
    P, _ = group_size_rank(group)
    if P == 1:
        return x
    s = list(x.shape)
    s[split:split + 1] = [P, s[split] // P]
    send = x.reshape(s).movedim(split, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(_pairs(recv), _pairs(send), group=group)
    del send
    return torch.cat(recv.unbind(0), dim=concat)


def gather_k1(q, group):
    """A (N0, N1/P) plane block -> the whole (N0, N1) plane on every
    rank."""
    P, _ = group_size_rank(group)
    if P == 1:
        return q
    q = q.contiguous()
    parts = [torch.empty_like(q) for _ in range(P)]
    dist.all_gather([_pairs(p) for p in parts], _pairs(q), group=group)
    return torch.cat(parts, dim=1)


def packed_to_complex(S, group, dtype=torch.complex128):
    """This rank's block of a packed state (2, C, N0, N1/P, h) -> its
    block of the complex state (C, N0, N1/P, h + 1): X0 = (Q + conj
    Q(−k))/2 and X_Nyq = (Q − conj Q(−k))/(2i) on plane k2 = 0, Q's
    flip-conjugate taken over the gathered (k0, k1) plane."""
    P, rank = group_size_rank(group)
    C, n0, n1, h = S.shape[1:]
    out = torch.empty((C, n0, n1, h + 1), dtype=dtype, device=S.device)
    blk = slice(rank * n1, (rank + 1) * n1)
    for c in range(C):
        z = torch.complex(S[0, c].to(torch.float64),
                          S[1, c].to(torch.float64))
        q = z[..., 0]
        qf = flipconj(gather_k1(q, group))[:, blk]
        out[c, ..., 0] = 0.5 * (q + qf)
        out[c, ..., -1] = (q - qf) / 2j
        out[c, ..., 1:-1] = z[..., 1:]
    return out


def to_complex(S, group, dtype=torch.complex128):
    """This rank's block of a state in either layout -> its block of the
    complex layout in ``dtype``."""
    if S.is_complex():
        return S.to(dtype)
    return packed_to_complex(S, group, dtype)


class NS3DSlab(NS3D):
    """``reference/ns3d.py``'s solver over the slab of ``group`` (None: a
    world of one, which is ``NS3D``).  The state is this rank's spectral
    block (3, N0, N1/P, Nf); ``rhs``, ``step`` and ``run`` are NS3D's, on
    the block's wavenumbers and mask."""

    def __init__(self, N, L, nu, dt, dealias, precision="float64",
                 device="cuda", group=None):
        if dealias != TWO_THIRDS:
            raise ValueError(f"the slab reference takes {TWO_THIRDS!r}, got "
                             f"{dealias!r}")
        super().__init__(N, L, nu, dt, dealias, precision, device)
        self.group = group
        self.P, self.rank = group_size_rank(group)
        n0, n1 = self.N[0] // self.P, self.N[1] // self.P
        if n0 * self.P != self.N[0] or n1 * self.P != self.N[1]:
            raise ValueError(f"N0 and N1 of {self.N} must divide by "
                             f"P = {self.P}")
        self.rows = slice(self.rank * n0, (self.rank + 1) * n0)
        blk = slice(self.rank * n1, (self.rank + 1) * n1)
        K0, K1, K2 = self.K
        self.K = (K0, K1[:, blk], K2)
        self.ksq = self.K[0] ** 2 + self.K[1] ** 2 + self.K[2] ** 2
        self.mask = self.mask[:, blk]

    def ifft(self, X):
        """One component's block (N0, N1/P, Nf) -> its physical block
        (N0/P, N1, N2)."""
        X = torch.fft.ifft(self._in(X), dim=0)
        X = all_to_all(X, self.group, 0, 1)
        return torch.fft.irfft2(self._in(X), s=self.N[1:], dim=(1, 2))

    def _forward(self, f):
        """A physical block (N0/P, N1, N2) -> its spectral block (N0,
        N1/P, Nf), unmasked."""
        X = torch.fft.rfft2(self._in(f), dim=(1, 2))
        X = all_to_all(X, self.group, 1, 0)
        return torch.fft.fft(self._in(X), dim=0)

    def fft(self, f):
        return self._forward(f) * self.mask

    def energy(self, U):
        """0.5 <|u|²> by Parseval, the blocks' sums added over the group."""
        e = torch.tensor([super().energy(U)], dtype=torch.float64,
                         device=U.device)
        if self.P > 1:
            dist.all_reduce(e, group=self.group)
        return float(e[0])

    def taylor_green(self, device):
        """The Taylor–Green velocity on this rank's physical block,
        transformed: the block of ``NS3D.taylor_green``'s state."""
        x = [torch.arange(n, dtype=self.rdt, device=device) * (2 * math.pi / n)
             for n in self.N]
        x0 = x[0][self.rows]
        s0, c0 = torch.sin(x0)[:, None, None], torch.cos(x0)[:, None, None]
        s1, c1 = torch.sin(x[1])[None, :, None], torch.cos(x[1])[None, :, None]
        c2 = torch.cos(x[2])[None, None, :]
        U = torch.empty((3, self.N[0], self.N[1] // self.P, self.nf),
                        dtype=self.cdt, device=device)
        U[0] = self._forward(s0 * c1 * c2)
        U[1] = self._forward(-c0 * s1 * c2)
        U[2] = 0
        return U
