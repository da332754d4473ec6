"""Plain pseudo-spectral incompressible Navier–Stokes on a periodic box,
rotational form, velocity in spectral space (the r2c layout, numpy's
unnormalised forward):

    dÛ/dt = P[ F̂(u × ω) ] − ν k² Û,   ω = ifftn(i K × Û),
    P(F̂) = F̂ − K (K·F̂)/|K|²   (|K|² = 0 taken as 1),

classic RK4.  The nonlinear term is dealiased by the 2/3 rule (keep
|k_i| < (2/3)(N_i/2) on each axis) or by the 3/2 rule: u and ω on the
grid M = 3N/2 (the spectrum zero-padded, the full axes' Nyquist split
between ±N/2, the half axis' halved), the product's spectrum truncated
back (the split Nyquist summed) and its z-Nyquist plane set to the alias
sum q + conj(q(−k0, −k1)).  Every transform takes one component, so a
768³ step fits beside the program's state.
"""

import math

import torch

from . import dtypes

TWO_THIRDS, THREE_HALVES = "2/3-rule", "3/2-rule"


def _freqs(n, dtype, device):
    return torch.fft.fftfreq(n, 1.0 / n, dtype=dtype, device=device)


def pad_full(x, axis, m):
    n = x.shape[axis]
    h = n // 2
    lo, ny, hi = x.narrow(axis, 0, h), x.narrow(axis, h, 1), \
        x.narrow(axis, h + 1, n - h - 1)
    zshape = list(x.shape)
    zshape[axis] = m - n - 1
    return torch.cat([lo, 0.5 * ny, x.new_zeros(zshape), 0.5 * ny, hi], axis)


def trunc_full(x, axis, n):
    m = x.shape[axis]
    h = n // 2
    return torch.cat([x.narrow(axis, 0, h),
                      x.narrow(axis, h, 1) + x.narrow(axis, m - h, 1),
                      x.narrow(axis, m - h + 1, h - 1)], axis)


def flipconj(q):
    """conj(q(−k0, −k1)) of a plane in fft layout."""
    return torch.roll(torch.flip(q, (0, 1)), (1, 1), (0, 1)).conj()


class NS3D:
    """The reference solver.  ``N``, ``L``: grid and box; ``precision``:
    "float64" or "tf32" (the control)."""

    def __init__(self, N, L, nu, dt, dealias, precision="float64",
                 device="cuda"):
        if dealias not in (TWO_THIRDS, THREE_HALVES):
            raise ValueError(f"dealias must be {TWO_THIRDS!r} or "
                             f"{THREE_HALVES!r}, got {dealias!r}")
        self.N = tuple(int(n) for n in N)
        self.nu, self.dt, self.dealias = float(nu), float(dt), dealias
        self.rdt, self.cdt, self.rnd = dtypes(precision)
        n0, n1, n2 = self.N
        self.nf = n2 // 2 + 1
        s = [2 * math.pi / float(x) for x in L]
        k = (_freqs(n0, self.rdt, device) * s[0],
             _freqs(n1, self.rdt, device) * s[1],
             torch.arange(self.nf, dtype=self.rdt, device=device) * s[2])
        self.K = (k[0][:, None, None], k[1][None, :, None],
                  k[2][None, None, :])
        self.ksq = self.K[0] ** 2 + self.K[1] ** 2 + self.K[2] ** 2
        if dealias == TWO_THIRDS:
            ki = (_freqs(n0, torch.float64, device).abs()[:, None, None],
                  _freqs(n1, torch.float64, device).abs()[None, :, None],
                  torch.arange(self.nf, dtype=torch.float64,
                               device=device)[None, None, :])
            self.mask = ((ki[0] < (2 / 3) * (n0 // 2))
                         & (ki[1] < (2 / 3) * (n1 // 2))
                         & (ki[2] < (2 / 3) * (n2 // 2)))
            self.M = self.N
        else:
            self.M = tuple(3 * n // 2 for n in self.N)
        w = torch.full((self.nf,), 2.0, dtype=torch.float64, device=device)
        w[0] = 1.0
        w[n2 // 2] = 1.0
        self.w = w

    def _in(self, x):
        return x if self.rnd is None else self.rnd(x)

    def ifft(self, X):
        """One component's spectrum (N0, N1, Nf) -> its physical field on
        the working grid (N, or M under the 3/2 rule)."""
        if self.dealias == THREE_HALVES:
            X = pad_full(pad_full(X, 0, self.M[0]), 1, self.M[1])
            nf = self.nf
            X = torch.cat([X[..., :nf - 1], 0.5 * X[..., nf - 1:],
                           X.new_zeros(X.shape[:2] + (self.M[2] // 2 + 1
                                                       - nf,))], -1)
            scale = math.prod(self.M) / math.prod(self.N)
            return torch.fft.irfftn(self._in(X), s=self.M) * scale
        return torch.fft.irfftn(self._in(X), s=self.N)

    def fft(self, f):
        """A physical field on the working grid -> its dealiased spectrum
        (N0, N1, Nf)."""
        X = torch.fft.rfftn(self._in(f))
        if self.dealias == TWO_THIRDS:
            return X * self.mask
        X = trunc_full(trunc_full(X[..., :self.nf], 0, self.N[0]), 1,
                       self.N[1])
        X = X * (math.prod(self.N) / math.prod(self.M))
        q = X[..., self.nf - 1]
        X[..., self.nf - 1] = q + flipconj(q)
        return X

    def rhs(self, U):
        K = self.K
        u = [self.ifft(U[c]) for c in range(3)]
        w = [self.ifft(1j * (K[a] * U[b] - K[b] * U[a]))
             for a, b in ((1, 2), (2, 0), (0, 1))]
        F = torch.stack([self.fft(u[a] * w[b] - u[b] * w[a])
                         for a, b in ((1, 2), (2, 0), (0, 1))])
        del u, w
        div = ((K[0] * F[0] + K[1] * F[1] + K[2] * F[2])
               / torch.where(self.ksq == 0, 1.0, self.ksq))
        for c in range(3):
            F[c] -= K[c] * div
        return F.sub_((self.nu * self.ksq) * U)

    def step(self, U):
        dt = self.dt
        k = self.rhs(U)
        acc = U + (dt / 6.0) * k
        k = self.rhs(U + (0.5 * dt) * k)
        acc.add_(k, alpha=dt / 3.0)
        k = self.rhs(U + (0.5 * dt) * k)
        acc.add_(k, alpha=dt / 3.0)
        k = self.rhs(U + dt * k)
        return acc.add_(k, alpha=dt / 6.0)

    def energy(self, U):
        """0.5 <|u|²> by Parseval, summed in float64."""
        e = sum(torch.sum((U[c].real.double() ** 2 + U[c].imag.double() ** 2)
                          * self.w) for c in range(U.shape[0]))
        return float(0.5 * e / float(math.prod(self.N)) ** 2)

    def run(self, U, n_steps, monitor_every):
        """The program's ``run`` contract: ``n_steps`` steps and the energy
        every ``monitor_every``; returns (state, energies)."""
        U = U.to(self.cdt)
        energies = []
        for i in range(1, n_steps + 1):
            U = self.step(U)
            if i % monitor_every == 0:
                energies.append(self.energy(U))
        return U, torch.tensor(energies, dtype=torch.float64)

    def taylor_green(self, device):
        """The Taylor–Green velocity (sin x cos y cos z, −cos x sin y cos z,
        0) on the N grid, transformed."""
        x = [torch.arange(n, dtype=self.rdt, device=device) * (2 * math.pi / n)
             for n in self.N]
        s0, c0 = torch.sin(x[0])[:, None, None], torch.cos(x[0])[:, None, None]
        s1, c1 = torch.sin(x[1])[None, :, None], torch.cos(x[1])[None, :, None]
        c2 = torch.cos(x[2])[None, None, :]
        U = torch.empty((3, self.N[0], self.N[1], self.nf), dtype=self.cdt,
                        device=device)
        U[0] = torch.fft.rfftn(s0 * c1 * c2)
        U[1] = torch.fft.rfftn(-c0 * s1 * c2)
        U[2] = 0
        return U
