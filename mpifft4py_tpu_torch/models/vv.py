"""Velocity–vorticity formulation of 3D incompressible Navier–Stokes.

Port of ``mpifft4py_tpu/models/vv.py``.  The state is the spectral
vorticity ω̂; the velocity comes back by Biot–Savart in every right-hand
side:

    û = i (K × ω̂) / |K|²              (exact since K·û = 0)
    ∂ω̂/∂t = i K × F̂(u × ω) − ν k² ω̂    (the curl of the rotational form:
                                         the pressure term vanishes)

In exact arithmetic the VV trajectory is the curl of the velocity form's
(curl ∘ Leray projection = curl), which the tests use as an oracle.

* ``spectral_layout="complex"``: the state is a complex (3, N0, N1, Nf)
  tensor; each right-hand side runs two batched inverse calls (velocity,
  vorticity) and one forward.
* ``spectral_layout="packed"``: the state is one (2, 3, N0, N1, N2/2)
  float32 tensor.  ``rhs_packed`` runs the Biot–Savart curl kernel (the
  velocity ÷ |K|² and the vorticity from one pass over the state pair),
  the cross kernel and the epilogue kernel in mode "curl".

The reference's streamed right-hand side (``_rhs_packed_lowmem``) and its
fold integrator path, which fit 768³ on a 16 GB chip, are not ported
(ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.fft3d import cross, inv_ksq, kcross, kvecs
from ..utils import spectral
from .navier_stokes import NavierStokes3D, SpectralSolver


class VorticityVelocity3D(SpectralSolver):
    """Vorticity-form pseudo-spectral solver over a ``slab.R2C``."""

    def __init__(self, FFT, nu: float, dt: float,
                 dealias: Optional[str] = "2/3-rule",
                 integrator: str = "RK4", spectral_layout: str = "complex"):
        self.nu = float(nu)
        self._init_solver(FFT, dt, dealias, integrator, spectral_layout)

    # -- state construction ---------------------------------------------------------

    def from_velocity(self, U_hat):
        """Spectral vorticity ω̂ = i K × û of a complex (3,) + spectral
        velocity."""
        return 1j * kcross(kvecs(*self._complex_k_args()), U_hat)

    def velocity(self, W_hat):
        """Biot–Savart: û = i (K × ω̂)/|K|² (complex layout)."""
        k = self._complex_k_args()
        return 1j * kcross(kvecs(*k), W_hat) * inv_ksq(*k)

    def taylor_green(self):
        """The Taylor–Green vortex's vorticity: complex (3,) +
        global_complex_shape(), or the packed (2, 3, N0, N1, N2/2) state,
        the curl taken on the packed velocity pair."""
        ns = NavierStokes3D(self.FFT, nu=self.nu, dt=self.dt,
                            dealias=self.dealias,
                            spectral_layout=self.spectral_layout)
        U = ns.taylor_green()
        if self.spectral_layout != "packed":
            return self.from_velocity(U)
        K = kvecs(*self._step_args()[:3])
        return torch.stack([-kcross(K, U[1]), kcross(K, U[0])])

    # -- dynamics ---------------------------------------------------------------------

    def rhs(self, W_hat, k0, k1, k2):
        """dω̂/dt from the factored 1-D wavenumbers (k0, k1, k2)."""
        K = kvecs(k0, k1, k2)
        U = self._bwd_nl(1j * kcross(K, W_hat) * inv_ksq(k0, k1, k2))
        W = self._bwd_nl(W_hat)
        F_hat = self._fwd(cross(U, W))
        del U, W
        # the curl of the nonlinear term; the pressure never appears
        return (1j * kcross(K, F_hat)
                - (self.nu * spectral.ksq(k0, k1, k2))[None] * W_hat)

    def rhs_packed(self, Wr, Wi, k0, k1, k2, m0, m1, m2):
        """dω/dt on the packed layout, as one (2, 3, N0, N1, h) tensor: the
        Biot–Savart curl kernel inverts the velocity (÷ |K|²) and the
        vorticity from one pass over the state pair, then the cross kernel
        and the epilogue kernel in mode "curl" give
        mask·(i K × F̂(u × ω)) − ν k² ω̂."""
        # the kernel's curl pass is the velocity, its state pass ω itself
        W, U = self._bwd_state_curl_pk(Wr, Wi, k0, k1, k2, biot_savart=True)
        return self._nl_fwd_epilogue_pk(U, W, Wr, Wi,
                                        (k0, k1, k2, m0, m1, m2), "curl",
                                        self.nu)

    # -- diagnostics ------------------------------------------------------------------

    def energy(self, W_hat) -> float:
        """Mean kinetic energy 0.5 <|u|²> of the Biot–Savart velocity: in
        physical space, or the Parseval sum for the packed layout."""
        if self.spectral_layout == "packed":
            k = self._step_args()[:3]
            inv = inv_ksq(*k)
            K = kvecs(*k)
            return float(self._packed_energy(
                (-kcross(K, W_hat[1]) * inv, kcross(K, W_hat[0]) * inv)))
        U = self._bwd(self.velocity(W_hat))
        return float(0.5 * self.staged_mean(torch.sum(U * U, dim=0)))

    def enstrophy(self, W_hat) -> float:
        """0.5 <|ω|²>: in physical space, or the Parseval sum of ω̂ itself
        for the packed layout."""
        if self.spectral_layout == "packed":
            return self.energy_packed(W_hat)
        W = self._bwd(W_hat)
        return float(0.5 * self.staged_mean(torch.sum(W * W, dim=0)))
