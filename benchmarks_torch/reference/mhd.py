"""Plain pseudo-spectral incompressible magnetohydrodynamics on a periodic
box: the (u, b) rotational form in Alfvén units that spectralDNS's MHD
solver steps, both fields in spectral space (the r2c layout, numpy's
unnormalised forward):

    dÛ/dt = P[ F̂(u × ω + j × b) ] − ν k² Û,   ω = ∇ × u,  j = ∇ × b,
    dB̂/dt = i K × F̂(u × b) − η k² B̂,

P the Leray projection of ``ns3d.NS3D`` (|K|² = 0 taken as 1), classic
RK4, the nonlinear terms dealiased as ``ns3d.NS3D`` does (the 2/3 rule
for the benchmark's cell).  The state stacks (Û, B̂) as (6, N0, N1,
N2/2 + 1).  Every transform takes one component and the products are
formed a field at a time, so the 512³ float64 step fits one card beside
the program's two states.

Departures from the source (Lee et al., PRE 78 (2008) 066401; Pouquet et
al., GAFD 104 (2010) 115, the insulating Taylor–Green flow with ν = η):
the source's runs impose the flow's symmetries and step a fraction of the
box; here the whole periodic box is stepped, and the benchmark adds a
seeded perturbation that breaks the symmetries.  The time scheme is RK4
at a fixed dt.  The induction term is written as the curl of the
transformed electromotive force (i K × F̂(u × b), spectralDNS's form), so
∇·b stays at round-off whatever the aliasing.
"""

import math

import torch

from .ns3d import NS3D

CROSS = ((1, 2), (2, 0), (0, 1))    # (a, b) of each component of x × y


def _cross(x, y):
    return [x[a] * y[b] - x[b] * y[a] for a, b in CROSS]


class MHD(NS3D):
    """The reference solver: ``ns3d.NS3D``'s grid, transforms, RK4 step,
    energy and ``run``, with the MHD right-hand side.  ``precision``:
    "float64" or "tf32" (the control)."""

    def __init__(self, N, L, nu, eta, dt, dealias, precision="float64",
                 device="cuda"):
        super().__init__(N, L, nu, dt, dealias, precision, device)
        self.eta = float(eta)

    def _curl(self, X):
        """The physical components of the curl of a spectral 3-stack."""
        K = self.K
        return [self.ifft(1j * (K[a] * X[b] - K[b] * X[a])) for a, b in CROSS]

    def rhs(self, S):
        K = self.K
        U, B = S[:3], S[3:]
        u = [self.ifft(U[c]) for c in range(3)]
        b = [self.ifft(B[c]) for c in range(3)]
        f = _cross(u, self._curl(U))                         # u × ω
        f = [x + y for x, y in zip(f, _cross(self._curl(B), b))]  # + j × b
        F = torch.stack([self.fft(x) for x in f])
        del f
        out = torch.empty_like(S)
        div = ((K[0] * F[0] + K[1] * F[1] + K[2] * F[2])
               / torch.where(self.ksq == 0, 1.0, self.ksq))
        for c in range(3):
            out[c] = F[c] - K[c] * div - (self.nu * self.ksq) * U[c]
        del div
        F = torch.stack([self.fft(x) for x in _cross(u, b)])  # u × b
        del u, b
        for c, (a, e) in enumerate(CROSS):
            out[3 + c] = (1j * (K[a] * F[e] - K[e] * F[a])
                          - (self.eta * self.ksq) * B[c])
        return out

    def taylor_green_mhd(self, device, b0):
        """The insulating Taylor–Green state: u = (sin x cos y cos z,
        −cos x sin y cos z, 0), b = b0·(cos x sin y sin z, sin x cos y
        sin z, −2 sin x sin y cos z) on the N grid, transformed."""
        x = [torch.arange(n, dtype=self.rdt, device=device) * (2 * math.pi / n)
             for n in self.N]
        s = [torch.sin(v) for v in x]
        c = [torch.cos(v) for v in x]

        def field(f0, f1, f2):
            return f0[:, None, None] * f1[None, :, None] * f2[None, None, :]
        u0 = field(s[0], c[1], c[2])
        fields = (u0, -field(c[0], s[1], c[2]), torch.zeros_like(u0),
                  b0 * field(c[0], s[1], s[2]), b0 * field(s[0], c[1], s[2]),
                  -2.0 * b0 * field(s[0], s[1], c[2]))
        return torch.stack([torch.fft.rfftn(f) for f in fields])
