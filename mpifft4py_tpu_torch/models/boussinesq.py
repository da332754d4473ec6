"""Boussinesq convection: Navier–Stokes with buoyant scalar transport.

Port of ``mpifft4py_tpu/models/boussinesq.py``.  The momentum takes a
buoyancy force Ri·θ along the last axis (gravity along z); the scalar is
advected in conservative form (incompressibility makes u·∇θ = ∇·(uθ)), so
its spectral divergence is exact:

    ∂û/∂t = P[ F̂(u × ω) + Ri θ̂ ê_z ] − ν k² û
    ∂θ̂/∂t = − i K · F̂(u θ) − κ k² θ̂

The state stacks both: (4,) + global_complex_shape() in the complex layout
(components 0..2 = û, 3 = θ̂), one (2, 4, N0, N1, N2/2) float32 tensor in
the packed layout.

``rhs_packed`` runs the curl kernel (U and ω from one pass), the packed
inverse of θ̂, the cross kernel with the epilogue kernel's buoyancy rider
("project", Ri·θ̂ added to F̂_z after the mask and before the projection)
and the mul kernel (u_c·θ) with the epilogue in mode "div", each epilogue
writing its part of one (2, 4, …) increment.  The reference's fold
integrator path is not ported (ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.fft3d import cross, inv_ksq, kcross, kdot, kvecs
from ..utils import spectral
from .navier_stokes import SpectralSolver


class Boussinesq3D(SpectralSolver):
    """Buoyancy-coupled pseudo-spectral solver over a ``slab.R2C``.

    Args:
      nu: viscosity; kappa: scalar diffusivity; Ri: Richardson number (the
      buoyancy's strength), gravity along axis 2 (z).
    """

    def __init__(self, FFT, nu: float, kappa: float, dt: float,
                 Ri: float = 1.0, dealias: Optional[str] = "2/3-rule",
                 integrator: str = "RK4", spectral_layout: str = "complex"):
        self.nu = float(nu)
        self.kappa = float(kappa)
        self.Ri = float(Ri)
        self._init_solver(FFT, dt, dealias, integrator, spectral_layout)

    # -- initial conditions ---------------------------------------------------------

    def _state_of(self, fields):
        fs = self._fwd_plain(torch.stack(fields))
        return self.to_packed(fs) if self.spectral_layout == "packed" else fs

    def _theta(self, theta0):
        """θ = theta0·sin(z) on the physical grid, from the 1-D sine."""
        x0, x1, x2 = self.FFT._local_coords()
        return (theta0 * torch.sin(x2)).expand(len(x0), len(x1), len(x2))

    def taylor_green_stratified(self, theta0: float = 0.1):
        """Taylor–Green velocity and θ = theta0·sin(z): the stacked (4,) +
        spectral state (packed under spectral_layout='packed'), from the
        sines and cosines of the 1-D coordinates."""
        x0, x1, x2 = self.FFT._local_coords()
        s0, c0 = torch.sin(x0)[:, None, None], torch.cos(x0)[:, None, None]
        s1, c1 = torch.sin(x1)[None, :, None], torch.cos(x1)[None, :, None]
        c2 = torch.cos(x2)[None, None, :]
        u0 = s0 * c1 * c2
        return self._state_of([u0, -c0 * s1 * c2, torch.zeros_like(u0),
                               self._theta(theta0)])

    def rest_state(self, theta0: float = 0.1):
        """u = 0, θ = theta0·sin(z): the buoyancy is a pure gradient, so the
        projected dynamics keep the fluid at rest while θ diffuses."""
        th = self._theta(theta0)
        z = torch.zeros_like(th)
        return self._state_of([z, z, z, th])

    # -- dynamics ---------------------------------------------------------------------

    def rhs(self, S_hat, k0, k1, k2):
        """d(û, θ̂)/dt on the stacked (4,) + spectral state."""
        K = kvecs(k0, k1, k2)
        U_hat, T_hat = S_hat[:3], S_hat[3]
        UT = self._bwd_nl(S_hat)                  # u and θ in one call
        W = self._bwd_nl(1j * kcross(K, U_hat))
        U, th = UT[:3], UT[3]
        # u × ω and the scalar flux u θ, forward in one call
        G = self._fwd(torch.cat([cross(U, W), U * th[None]]))
        del UT, W, U, th
        F_hat, G_hat = G[:3], G[3:]
        # the buoyancy Ri·θ̂ ê_z joins the force before the projection
        F_hat[2].add_(T_hat, alpha=self.Ri)
        ksq = spectral.ksq(k0, k1, k2)
        div = kdot(K, F_hat) * inv_ksq(k0, k1, k2)
        dU = (F_hat - torch.stack([K[0] * div, K[1] * div, K[2] * div])
              - (self.nu * ksq)[None] * U_hat)
        # the conservative scalar flux: dθ̂ = −i K·F̂(uθ) − κ k² θ̂
        dT = -1j * kdot(K, G_hat) - self.kappa * ksq * T_hat
        return torch.cat([dU, dT[None]])

    def rhs_packed(self, Sr, Si, k0, k1, k2, m0, m1, m2):
        """d(û, θ̂)/dt on the packed layout, as one (2, 4, N0, N1, h)
        tensor: U and ω from one curl-kernel pass, θ from the packed
        inverse; the momentum P[mask·F̂(U × ω) + Ri θ̂ ê_z] − ν k² û from the
        cross kernel and the epilogue's buoyancy rider, the scalar
        −i K·mask·F̂(U θ) − κ k² θ̂ from the mul kernel and the epilogue in
        mode "div"."""
        Ur, Ui, Tr, Ti = Sr[:3], Si[:3], Sr[3:], Si[3:]
        kargs = (k0, k1, k2, m0, m1, m2)
        U, W = self._bwd_state_curl_pk(Ur, Ui, k0, k1, k2)
        th = self._bwd_pk((Tr[0], Ti[0]))
        dS = torch.empty((2,) + tuple(Sr.shape), dtype=Sr.dtype,
                         device=Sr.device)
        self._nl_fwd_epilogue_pk(U, W, Ur, Ui, kargs, "project", self.nu,
                                 buoy=(Tr, Ti, self.Ri), out=dS[:, :3])
        self._nl_mul_epilogue_pk(U, th[None], Tr, Ti, kargs, self.kappa,
                                 out=dS[:, 3:])
        return dS

    # -- diagnostics ------------------------------------------------------------------

    def energies(self, S_hat):
        """(kinetic, scalar-variance) means 0.5<|u|²>, 0.5<θ²>: in physical
        space, or the Parseval sums for the packed layout."""
        if self.spectral_layout == "packed":
            e = self._packed_component_energies(S_hat)
            return float(torch.sum(e[:3])), float(e[3])
        UT = self._bwd(S_hat)
        sm = self.staged_mean
        return (float(0.5 * sm(torch.sum(UT[:3] * UT[:3], dim=0))),
                float(0.5 * sm(UT[3] * UT[3])))
