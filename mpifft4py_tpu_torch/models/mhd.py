"""Pseudo-spectral incompressible 3D magnetohydrodynamics.

Port of ``mpifft4py_tpu/models/mhd.py``.  The (u, b) rotational form in
Alfvén units:

    ∂û/∂t = P[ F̂(u × ω + j × b) ] − ν k² û          ω = ∇ × u,  j = ∇ × b
    ∂b̂/∂t = i K × F̂(u × b) − η k² b̂

The induction term is curled after the forward transform, so ∇·b = 0 holds
to round-off whatever the aliasing.  The state stacks both fields: (6,) +
global_complex_shape() in the complex layout (components 0..2 = û,
3..5 = b̂), one (2, 6, N0, N1, N2/2) float32 tensor in the packed layout,
so every integrator of ``navier_stokes.INTEGRATORS`` applies unchanged.

``rhs_packed`` runs the curl kernel once for each field (state and curl
from one pass), the cross kernel with its cross2 load for the momentum
(U × ω + J × B from four physical stacks in one launch) and the epilogue
kernel in modes "project" and "curl", each writing its half of one
(2, 6, …) increment.  The reference's sequenced right-hand side for
512-class grids (``_rhs_packed_seq``, which keeps four physical stacks off
a 16 GB chip) and its fold integrator path are not ported (ROADMAP.md
queue 1 item 5).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.fft3d import cross, inv_ksq, kcross, kdot, kvecs
from ..utils import spectral
from .navier_stokes import SpectralSolver


class MHD3D(SpectralSolver):
    """Incompressible MHD over a ``slab.R2C``.

    Args:
      FFT: a ``slab.R2C`` instance.
      nu: kinematic viscosity; eta: magnetic diffusivity.
      dt: timestep.
      dealias: applied to the nonlinear forward transforms.
      integrator: one of ``navier_stokes.INTEGRATORS``.
    """

    def __init__(self, FFT, nu: float, eta: float, dt: float,
                 dealias: Optional[str] = "2/3-rule", integrator: str = "RK4",
                 spectral_layout: str = "complex"):
        self.nu = float(nu)
        self.eta = float(eta)
        self._init_solver(FFT, dt, dealias, integrator, spectral_layout)

    # -- initial conditions ---------------------------------------------------------

    def taylor_green_mhd(self, b0: float = 0.1):
        """Taylor–Green velocity and a perpendicular seed field,
        b = b0·(cos x sin y sin z, sin x cos y sin z, −2 sin x sin y cos z):
        the stacked (6,) + global_complex_shape() spectral state, or the
        packed (2, 6, N0, N1, N2/2) one.  The fields are products of the
        sines and cosines of the 1-D coordinates, broadcast (as
        ``NavierStokes3D.taylor_green``)."""
        x0, x1, x2 = self.FFT._local_coords()
        s0, c0 = torch.sin(x0)[:, None, None], torch.cos(x0)[:, None, None]
        s1, c1 = torch.sin(x1)[None, :, None], torch.cos(x1)[None, :, None]
        s2, c2 = torch.sin(x2)[None, None, :], torch.cos(x2)[None, None, :]
        u0 = s0 * c1 * c2
        f = torch.stack([u0, -c0 * s1 * c2, torch.zeros_like(u0),
                         b0 * (c0 * s1 * s2), b0 * (s0 * c1 * s2),
                         b0 * (-2.0 * s0 * s1 * c2)])
        fub = self._fwd_plain(f)
        return self.to_packed(fub) if self.spectral_layout == "packed" else fub

    # -- dynamics ---------------------------------------------------------------------

    def rhs(self, UB_hat, k0, k1, k2):
        """d(û, b̂)/dt on the stacked (6,) + spectral state."""
        K = kvecs(k0, k1, k2)
        U_hat, B_hat = UB_hat[:3], UB_hat[3:]
        UB = self._bwd_nl(UB_hat)
        WJ = self._bwd_nl(torch.cat([1j * kcross(K, U_hat),
                                     1j * kcross(K, B_hat)]))
        U, B, W, J = UB[:3], UB[3:], WJ[:3], WJ[3:]
        # u × ω + j × b (momentum) and u × b (the electromotive force)
        F_hat = self._fwd(torch.cat([cross(U, W) + cross(J, B),
                                     cross(U, B)]))
        del UB, WJ, U, B, W, J
        Fu_hat, Fb_hat = F_hat[:3], F_hat[3:]
        ksq = spectral.ksq(k0, k1, k2)
        div = kdot(K, Fu_hat) * inv_ksq(k0, k1, k2)
        dU = (Fu_hat - torch.stack([K[0] * div, K[1] * div, K[2] * div])
              - (self.nu * ksq)[None] * U_hat)
        # induction: i K × F̂(u × b) is divergence-free by construction
        dB = 1j * kcross(K, Fb_hat) - (self.eta * ksq)[None] * B_hat
        return torch.cat([dU, dB])

    def rhs_packed(self, UBr, UBi, k0, k1, k2, m0, m1, m2):
        """d(û, b̂)/dt on the packed layout, as one (2, 6, N0, N1, h)
        tensor: (U, ω) and (B, J) from one curl-kernel pass over each
        field; the momentum P[F̂(U × ω + J × B)] − ν k² û from the cross2
        and projection kernels, the induction i K × F̂(U × B) − η k² b̂
        from the cross and curl-epilogue kernels."""
        Ur, Ui, Br, Bi = UBr[:3], UBi[:3], UBr[3:], UBi[3:]
        kargs = (k0, k1, k2, m0, m1, m2)
        U, W = self._bwd_state_curl_pk(Ur, Ui, k0, k1, k2)   # ω = iK × û
        B, J = self._bwd_state_curl_pk(Br, Bi, k0, k1, k2)   # j = iK × b̂
        dS = torch.empty((2,) + tuple(UBr.shape), dtype=UBr.dtype,
                         device=UBr.device)
        self._nl_fwd_epilogue_pk(U, W, Ur, Ui, kargs, "project", self.nu,
                                 C=J, D=B, out=dS[:, :3])
        self._nl_fwd_epilogue_pk(U, B, Br, Bi, kargs, "curl", self.eta,
                                 out=dS[:, 3:])
        return dS

    # -- diagnostics ------------------------------------------------------------------

    def energies(self, UB_hat):
        """(kinetic, magnetic) mean energies 0.5<|u|²>, 0.5<|b|²>: in
        physical space, or the Parseval sums for the packed layout."""
        if self.spectral_layout == "packed":
            return self.energies_packed(UB_hat)
        UB = self._bwd(UB_hat)
        sm = self.staged_mean
        return (float(0.5 * sm(torch.sum(UB[:3] * UB[:3], dim=0))),
                float(0.5 * sm(torch.sum(UB[3:] * UB[3:], dim=0))))

    def energies_packed(self, UB):
        """(kinetic, magnetic) Parseval energies of the packed state."""
        e = self._packed_component_energies(UB)
        return float(torch.sum(e[:3])), float(torch.sum(e[3:]))

    def divergences(self, UB_hat):
        """(max |K·û|, max |K·b̂|) in spectral space: both ~0."""
        K = kvecs(*self._step_args()[:3])
        if self.spectral_layout == "packed":
            du = torch.sqrt(kdot(K, UB_hat[0][:3]) ** 2
                            + kdot(K, UB_hat[1][:3]) ** 2)
            db = torch.sqrt(kdot(K, UB_hat[0][3:]) ** 2
                            + kdot(K, UB_hat[1][3:]) ** 2)
        else:
            du = kdot(K, UB_hat[:3]).abs()
            db = kdot(K, UB_hat[3:]).abs()
        return float(du.max()), float(db.max())
