"""Pseudo-spectral incompressible 3D Navier–Stokes DNS.

Port of ``mpifft4py_tpu/models/navier_stokes.py`` (``SpectralSolver``, the
machinery the solver family shares — NS3D here, VV, MHD and Boussinesq in
their own modules — and ``NavierStokes3D``) in both spectral layouts.
Rotational form, velocity in spectral space:

    dU_hat/dt = P[ F̂(U × ω) ] − ν k² U_hat,   ω = ifftn(i K × U_hat),
    P(F̂) = F̂ − K (K·F̂)/|K|²                   (Leray projection).

PyTorch runs eagerly: a step is a chain of tensor calls on the state's
device, and ``run`` is a Python loop.  At P > 1 (a slab or a pencil
``R2C`` over a process group) every rank steps its own block of the
state — the transform says which (``local_spectral_slices``: the slab
cuts k1, the pencil k1 and k2 in the complex layout and k1 over P1·P2 in
its WIDE packed layout), so the 1-D wavenumbers, masks and weights are
this rank's slices — and every sum over the field (energies, the band
forcing's norm) is all-reduced over the group.  Only ``NavierStokes3D``
runs at P > 1 so far.

* ``spectral_layout="complex"``: the state is a complex (3, N0, N1, Nf)
  tensor; each right-hand side does three batched transform calls
  (velocity, vorticity, nonlinear term), one launch sequence per 3-stack,
  and its pointwise stages (the curl, U × ω, the projection with the
  viscous term) in one pass each (``ops.fft3d.rhs_*``).
  Under ``dealias="3/2-rule"`` the velocity and vorticity come back on the
  padded grid and the nonlinear term's forward truncates to the N grid.
* ``spectral_layout="packed"``: the state is the packed planar float32 pair
  carried as ONE (2, 3, N0, N1, N2/2) tensor (``[0]``/``[1]`` are the
  contiguous re/im planes, so each integrator axpy is one launch), with no
  complex boundary anywhere.  The right-hand side runs through the fused
  kernels of ``ops.fft3d``: the curl with the state's x inverse, the cross
  product with the z/y forwards, and the x forward with the mask, the
  projection and the viscous term (``rhs_packed``, over the helpers
  ``_bwd_state_curl_pk`` and ``_nl_fwd_epilogue_pk`` that the family
  shares).  The reference's unfused branches (taken only when a TPU memory
  gate fails; the port's gates are shape predicates its packed envelope
  always passes), its streamed nonlinear term and its fold integrators,
  which fit 512³–768³ on a 16 GB chip, are not ported (ROADMAP.md queue 1
  item 5).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import fft3d as p3
from ..utils import profiling, spectral

_LSRK54_A = (
    0.0,
    -567301805773.0 / 1357537059087.0,
    -2404267990393.0 / 2016746695238.0,
    -3550918686646.0 / 2091501179385.0,
    -1275806237668.0 / 842570457699.0,
)
_LSRK54_B = (
    1432997174477.0 / 9575080441755.0,
    5161836677717.0 / 13612068292357.0,
    1720146321549.0 / 2090206949498.0,
    3134564353537.0 / 4481467310338.0,
    2277821191437.0 / 14882151754819.0,
)

INTEGRATORS = ("RK4", "LSRK54", "Euler", "AB2")


class SpectralSolver:
    """Shared machinery of the spectral solvers: integrators, factored
    wavenumbers, the AB2 carry, ``run`` and the packed layout's fused
    right-hand-side helpers.  Subclasses implement ``rhs(state, k0, k1,
    k2)`` and, for the packed layout, ``rhs_packed(Sr, Si, k0, k1, k2, m0,
    m1, m2)``; a subclass that runs at P > 1 sets ``_distributed``."""

    _distributed = False

    def _init_solver(self, FFT, dt, dealias, integrator,
                     spectral_layout: str = "complex"):
        if FFT.P > 1 and not self._distributed:
            raise NotImplementedError(
                f"{type(self).__name__} at P = {FFT.P}: only NavierStokes3D "
                f"is ported to P > 1 (ROADMAP.md queue 1 item 5)")
        if spectral_layout not in ("complex", "packed"):
            raise ValueError(f"spectral_layout must be 'complex' or 'packed', "
                             f"got {spectral_layout!r}")
        if integrator not in INTEGRATORS:
            raise ValueError(f"integrator must be one of {INTEGRATORS}, "
                             f"got {integrator!r}")
        self.FFT = FFT
        self.dt = float(dt)
        self.dealias = dealias
        self.integrator = integrator
        if spectral_layout == "packed":
            self._validate_packed()
            # the packed transforms (the 2/3-rule forward purifies and
            # masks; the state is always masked, so the inverse does not)
            self._fwd_pk = FFT.forward_packed_fn(dealias)
            self._bwd_pk = FFT.backward_packed_fn()
        self.spectral_layout = spectral_layout
        # stacks of fields ride one call per transform
        self._fwd = FFT.forward_fields_fn(dealias=dealias)
        self._fwd_plain = FFT.forward_fields_fn()
        self._bwd = FFT.backward_fields_fn()
        # 3/2 rule: the nonlinear term is formed on the padsize×-refined
        # grid; the 2/3 rule works on the N grid with the mask in _fwd
        self._bwd_nl = (FFT.backward_fields_fn(dealias)
                        if dealias == "3/2-rule" else self._bwd)

    def _factored_k(self):
        """1-D scaled wavenumbers (k0, k1, k2) matching complex_shape()
        (this rank's blocks), in FFT.float."""
        FFT = self.FFT
        return spectral.factored_wavenumbers(
            FFT.N, FFT.L, FFT.global_complex_shape()[2], FFT.float,
            FFT.device, FFT.local_spectral_slices("complex"))

    def _complex_k_args(self):
        """(k0, k1, k2) of the complex layout, whatever the solver's own
        layout (diagnostics and state conversions take them)."""
        if not hasattr(self, "_k_args"):
            self._k_args = self._factored_k()
        return self._k_args

    def _step_args(self):
        if self.spectral_layout != "packed":
            return self._complex_k_args()
        if not hasattr(self, "_pk_args"):
            self._pk_args = self._packed_arrays()
        return self._pk_args

    # -- packed spectral layout plumbing -------------------------------------------

    def _validate_packed(self):
        """The reference's envelope, which is also the fused kernels': every
        solver that passes runs its right-hand side through them."""
        FFT = self.FFT
        if not (self.dealias == "2/3-rule"
                and hasattr(FFT, "_packed_iface_ok")
                and FFT._packed_iface_ok(self.dealias)):
            raise ValueError(
                "spectral_layout='packed' needs a float32 R2C with every axis "
                "in the kernels' envelope, (N2/2) % 128 == 0 and "
                "dealias='2/3-rule'")

    def _packed_arrays(self, local: bool = True):
        """The packed RHS's factored state: 1-D scaled wavenumbers
        (k0, k1, k2), k2 = 0..h−1, and 1-D 2/3-rule masks (m0, m1, m2), on
        the device, cut to this rank's packed block (the whole axes with
        ``local=False``).  No (3, N0, N1, h) K array is ever
        materialised."""
        FFT = self.FFT
        slices = FFT.local_spectral_slices("packed") if local else None
        return (spectral.factored_wavenumbers(FFT.N, FFT.L, int(FFT.N[2]) // 2,
                                              torch.float32, FFT.device,
                                              slices)
                + spectral.packed_dealias_masks(FFT.N, FFT.device, slices))

    def _packed_blocks_are_complex(self) -> bool:
        """True where this rank's packed block holds the same (k0, k1) as
        its complex block (the slab; the pencil at P2 == 1), so the two
        layouts convert locally."""
        FFT = self.FFT
        return (FFT.local_spectral_slices("packed")[:2]
                == FFT.local_spectral_slices("complex")[:2])

    def to_packed(self, U_hat):
        """This rank's complex state (3,) + complex_shape() -> the packed
        state, one (2, 3, N0, n1, N2/2) float32 tensor (the pencil's
        alignment lanes dropped).  The state must be Nyquist-free
        (guaranteed under the 2/3 rule).  Where the packed layout cuts
        other axes than the complex one (the pencil at P2 > 1) the
        conversion is not local: ValueError."""
        if not self._packed_blocks_are_complex():
            raise ValueError("to_packed: this transform's packed blocks are "
                             "not its complex blocks; run forward_packed_fn "
                             "on the physical field")
        nf = int(self.FFT.N[2]) // 2 + 1
        return torch.stack(p3.pack_spectrum(U_hat[..., :nf]))

    def from_packed(self, U):
        """The packed state (a (2, …) tensor or an (re, im) pair) -> the
        complex (3,) + complex_shape() state."""
        ur, ui = U
        return self.FFT._unpack(ur, ui)

    def _parseval_component_energies(self):
        """A fn (Sr, Si) -> per-component Parseval energies
        0.5·Σ w·|ŝ_c|²/ntot², with the Hermitian weights of a purified
        packed pair (column k2 = 0 weight 1, the rest 2; no Nyquist
        column)."""
        w = spectral.packed_hermitian_weights(self.FFT.N, self.FFT.device)
        ntot = float(np.prod([int(n) for n in self.FFT.N]))

        def comp_e(Sr, Si):
            # per-axis sums keep each partial sum short (see staged_mean)
            e = (Sr * Sr + Si * Si) * w
            e = e.sum(dim=-1).sum(dim=-1).sum(dim=-1)
            return 0.5 * e / (ntot * ntot)
        return comp_e

    def _packed_component_energies(self, S) -> torch.Tensor:
        """Per-component Parseval energies (C,) of a packed state, summed
        over the group."""
        if not hasattr(self, "_comp_e"):
            self._comp_e = self._parseval_component_energies()
        return self.FFT._all_reduce(self._comp_e(S[0], S[1]))

    def _packed_energy(self, U) -> torch.Tensor:
        return torch.sum(self._packed_component_energies(U))

    def energy_packed(self, U) -> float:
        """Parseval total energy 0.5<Σ_c |u_c|²> of a packed state."""
        return float(self._packed_energy(U))

    # -- the packed right-hand sides' fused helpers ----------------------------------

    def _bwd_state_curl_pk(self, Vr, Vi, k0, k1, k2,
                           biot_savart: bool = False):
        """(ifft(V̂), ifft(i K × V̂ [/|K|²])) of a packed 3-stack: one pass of
        the curl kernel over the state pair inverts both (the kernel's
        order is curl first; views of one (6, N0, N1, N2) tensor).  At
        P > 1 the x inverse crosses the transpose, so the curl is pointwise
        and two packed inverses follow (the reference's distributed
        branch): each carries its own transform span, and the curl stays
        in the right-hand side's own time."""
        if self.FFT.P > 1:
            cr, ci = p3._curl_pair(Vr, Vi, p3.kvecs(k0, k1, k2))
            if biot_savart:
                inv = p3.inv_ksq(k0, k1, k2)
                cr, ci = cr * inv, ci * inv
            return self._bwd_pk((Vr, Vi)), self._bwd_pk((cr, ci))
        with profiling.span("mpifft.transform.backward"):
            W, V = p3.curl_irfft3d_packed(Vr, Vi, k0, k1, k2,
                                          self.FFT.global_real_shape(),
                                          biot_savart=biot_savart,
                                          with_state=True)
        return V, W

    def _nl_fwd_epilogue_pk(self, A, B, Sr, Si, kargs, mode, visc,
                            C=None, D=None, buoy=None, out=None):
        """purify(epilogue(mask·fft(A × B [+ C × D]) [+ Ri·θ̂ ê_z])) −
        visc·k²·S for physical 3-stacks A, B [, C, D] and the packed state
        (Sr, Si): the product rides the z/y forward kernels, the x forward
        the epilogue kernel (``mode`` "project" or "curl"; ``buoy`` =
        (θr, θi, Ri)).  Returns a (2, 3, N0, N1, h) tensor, or fills
        ``out``.  At P > 1 (NS3D: A × B, no rider) the slab's
        ``nl_forward_epilogue_fn`` runs the same kernels around the
        transpose."""
        with profiling.span("mpifft.transform.forward"):
            if self.FFT.P > 1:
                return self._nl_dist(mode, visc, (A, B, Sr, Si), out)
            Fzr, Fzi = p3.cross_rfft_zy_packed(A, B, C, D)
            d = p3.fft_x_epilogue_packed(Fzr, Fzi, Sr, Si, *kargs, mode,
                                         visc, buoy=buoy, out=out)
            p3.purify_plane0_dus(d[0], d[1])
            return d

    def _nl_mul_epilogue_pk(self, A, t, Sr, Si, kargs, visc, out=None):
        """The scalar-flux mirror of ``_nl_fwd_epilogue_pk``:
        purify(−i K·mask·fft(A·t)) − visc·k²·S for a physical 3-stack A,
        a (1, N0, N1, N2) field t and a (1, N0, N1, h) state.  Returns a
        (2, 1, N0, N1, h) tensor, or fills ``out``."""
        with profiling.span("mpifft.transform.forward"):
            Gzr, Gzi = p3.mul_rfft_zy_packed(A, t)
            d = p3.fft_x_epilogue_packed(Gzr, Gzi, Sr, Si, *kargs, "div",
                                         visc, out=out)
            p3.purify_plane0_dus(d[0], d[1])
            return d

    def _nl_dist(self, mode, visc, args, out):
        """The slab's ``nl_forward_epilogue_fn`` (cached per key) on
        ``args`` and the global 1-D wavenumbers and masks."""
        plans = self.__dict__.setdefault("_nl_dist_plans", {})
        key = (mode, float(visc))
        if key not in plans:
            plans[key] = self.FFT.nl_forward_epilogue_fn(
                mode, visc, dealias=self.dealias)
        if not hasattr(self, "_pk_global"):
            self._pk_global = self._packed_arrays(local=False)
        d = plans[key](*args, *self._pk_global)
        return d if out is None else out.copy_(d)

    def _rhs_state(self, V, *kargs):
        """The right-hand side of a state in this solver's layout."""
        with profiling.span("mpifft.solver.rhs"):
            if self.spectral_layout == "packed":
                return self.rhs_packed(V[0], V[1], *kargs)
            return self.rhs(V, *kargs)

    # -- time integrators ---------------------------------------------------------

    def _advance(self, rhs1, U):
        """One step of ``self.integrator``.  AB2 state is (U, f_prev), built
        by ``ab2_state``.  The caller's state is never written; the RK4 and
        LSRK54 accumulators are updated in place (they are the step's own
        tensors), so RK4 keeps one stage derivative alive, not four."""
        dt = self.dt
        it = self.integrator
        if it == "RK4":
            k = rhs1(U)
            acc = U + (dt / 6.0) * k
            k = rhs1(U + (0.5 * dt) * k)
            acc.add_(k, alpha=dt / 3.0)
            k = rhs1(U + (0.5 * dt) * k)
            acc.add_(k, alpha=dt / 3.0)
            k = rhs1(U + dt * k)
            return acc.add_(k, alpha=dt / 6.0)
        if it == "LSRK54":
            dU = None
            for a, b in zip(_LSRK54_A, _LSRK54_B):
                r = rhs1(U)
                dU = r if dU is None else r.add_(dU, alpha=a)
                U = U + (dt * b) * dU
            return U
        if it == "Euler":
            return U + dt * rhs1(U)
        # AB2: U_{n+1} = U_n + dt (1.5 f_n − 0.5 f_{n−1})
        Un, fprev = U
        f = rhs1(Un)
        return (Un + dt * (1.5 * f - 0.5 * fprev), f)

    def ab2_state(self, U):
        """(U, f(U)) for integrator='AB2': the first step reduces to Euler."""
        if self.integrator != "AB2":
            raise ValueError("ab2_state is only meaningful with integrator='AB2'")
        return (U, self._rhs_state(U, *self._step_args()))

    def step(self, state):
        with profiling.span("mpifft.solver.step"):
            k = self._step_args()
            return self._advance(lambda V: self._rhs_state(V, *k), state)

    def _carry_state(self, c):
        return c[0] if self.integrator == "AB2" else c

    @staticmethod
    def staged_mean(x):
        """Mean over all axes by sequential per-axis sums: each partial sum
        stays short (≤ max(N) terms), where one flat float32 sum over ~1e8
        elements drifts ~1e-4 relative."""
        n = float(x.numel())
        s = x
        for _ in range(x.ndim):
            s = s.sum(dim=-1)
        return s / n

    def _monitor(self, S):
        """Total Parseval energy of a spectral state (no inverse transforms)."""
        with profiling.span("mpifft.solver.monitor"):
            if self.spectral_layout == "packed":
                return self._packed_energy(S)
            from .diagnostics import _hermitian_weights
            w = _hermitian_weights(self.FFT)
            ntot = float(np.prod([int(n) for n in self.FFT.N]))
            mag = (S.real ** 2 + S.imag ** 2) * w
            return self.FFT._all_reduce(
                0.5 * self.staged_mean(mag) * mag.numel() / (ntot * ntot))

    def run(self, state, n_steps: int, monitor_every: Optional[int] = None):
        """``n_steps`` steps.  With ``monitor_every=k`` also returns the total
        Parseval energy every k steps, as a tensor of shape
        ``(n_steps // k,)`` on the state's device: ``(final_state, trace)``.
        """
        with profiling.span("mpifft.solver.run"):
            if monitor_every is None:
                for _ in range(n_steps):
                    state = self.step(state)
                return state
            k = int(monitor_every)
            if n_steps % k:
                raise ValueError(f"n_steps={n_steps} not divisible by "
                                 f"monitor_every={k}")
            trace = []
            for i in range(1, n_steps + 1):
                state = self.step(state)
                if i % k == 0:
                    trace.append(self._monitor(self._carry_state(state)))
            return state, torch.stack(trace)


class NavierStokes3D(SpectralSolver):
    """Pseudo-spectral NS3D over a ``slab.R2C`` or ``pencil.R2C``
    transform, at any P (the pencil in both alignments; its packed layout
    at P2 == 1 and in WIDE).

    Args:
      FFT: a ``slab.R2C`` or ``pencil.R2C`` instance.
      nu: kinematic viscosity.
      dt: timestep.
      dealias: None | "2/3-rule" | "3/2-rule", applied to the nonlinear
        term: the 2/3 rule masks its forward transform; the 3/2 rule forms
        U × ω on the padded grid M = padsize·N and truncates it back (not
        with ``spectral_layout="packed"``, as in the reference).
      integrator: one of INTEGRATORS.
      forcing_band, forcing_rate: ``(k_lo, k_hi)`` and ε of the
        constant-energy-injection band forcing f̂ = ε·û/(2·E_band) on modes
        k_lo ≤ |k| < k_hi.
    """

    _distributed = True

    def __init__(self, FFT, nu: float, dt: float,
                 dealias: Optional[str] = "2/3-rule",
                 spectral_layout: str = "complex", integrator: str = "RK4",
                 forcing_band: Optional[tuple] = None,
                 forcing_rate: float = 0.0):
        self.nu = float(nu)
        self.forcing_band = (None if forcing_band is None
                             else (float(forcing_band[0]),
                                   float(forcing_band[1])))
        self.forcing_rate = float(forcing_rate)
        self._init_solver(FFT, dt, dealias, integrator, spectral_layout)

    def taylor_green(self):
        """Taylor–Green vortex in spectral space: (3,) +
        global_complex_shape(), or the packed (2, 3, N0, N1, N2/2) state
        under spectral_layout='packed'.

        The field is formed from the sines and cosines of the 1-D
        coordinates, broadcast: the same products as over the 3-D mesh, with
        N0 + N1 + N2 evaluations of sin/cos instead of 6·N0·N1·N2 (on the
        CPU, the first multithreaded float32 sin/cos of a process can come
        out inaccurate in its last digits; small 1-D calls stay off that
        path)."""
        x0, x1, x2 = self.FFT._local_coords()
        s0, c0 = torch.sin(x0)[:, None, None], torch.cos(x0)[:, None, None]
        s1, c1 = torch.sin(x1)[None, :, None], torch.cos(x1)[None, :, None]
        c2 = torch.cos(x2)[None, None, :]
        u0 = s0 * c1 * c2
        u = torch.stack([u0, -c0 * s1 * c2, torch.zeros_like(u0)])
        if self.spectral_layout != "packed":
            return self._fwd_plain(u)
        if self._packed_blocks_are_complex():
            return self.to_packed(self._fwd_plain(u))
        return torch.stack(self._fwd_pk(u))

    def rhs(self, U_hat, k0, k1, k2):
        """dU_hat/dt from the factored 1-D wavenumbers (k0, k1, k2).  The
        pointwise stages are one pass each (``ops.fft3d.rhs_*``: a kernel
        in float32 on the card, the eager twin otherwise)."""
        U = self._bwd_nl(U_hat)
        # vorticity: ω = ifftn(i K × U_hat)
        W = self._bwd_nl(p3.rhs_curl(U_hat, k0, k1, k2))
        # nonlinear term F = U × ω (on the M grid under the 3/2 rule),
        # transformed with dealiasing back to the N grid
        F_hat = self._fwd(p3.rhs_cross(U, W))
        del U, W
        # Leray projection + viscous term
        dU = p3.rhs_leray_visc(F_hat, U_hat, k0, k1, k2, self.nu)
        if self.forcing_band is not None and self.forcing_rate > 0:
            K0, K1, K2v = p3.kvecs(k0, k1, k2)
            ksq = K0 * K0 + K1 * K1 + K2v * K2v
            klo, khi = self.forcing_band
            band = (ksq >= klo * klo) & (ksq < khi * khi)
            # Hermitian half-spectrum weights: k2 = 0 and the z-Nyquist
            # plane weigh 1, interior columns 2
            kny = float(np.pi * int(self.FFT.N[2]) / float(self.FFT.L[2]))
            w = torch.where((K2v == 0) | (K2v >= kny * (1.0 - 1e-6)), 1.0, 2.0)
            ntot = float(np.prod([int(n) for n in self.FFT.N]))
            Eb = self.FFT._all_reduce(
                torch.sum(torch.where(band, w * U_hat.abs() ** 2, 0.0))
                / (2.0 * ntot * ntot))
            alpha = torch.where(Eb > 0, self.forcing_rate / (2.0 * Eb), 0.0)
            dU = dU + (alpha * band) * U_hat
        return dU

    def rhs_packed(self, Ur, Ui, k0, k1, k2, m0, m1, m2):
        """dU/dt on the packed layout, as one (2, 3, N0, N1, h) tensor: the
        curl kernel inverts the vorticity and the state from one pass over
        the state pair; the cross kernel forms U × ω under the z/y
        forwards; the epilogue kernel runs the x forward, the mask, the
        projection and −ν k² Û; the plane-0 purify is a column update."""
        U, W = self._bwd_state_curl_pk(Ur, Ui, k0, k1, k2)
        dU = self._nl_fwd_epilogue_pk(U, W, Ur, Ui,
                                      (k0, k1, k2, m0, m1, m2), "project",
                                      self.nu)
        del U, W
        if self.forcing_band is not None and self.forcing_rate > 0:
            klo, khi = self.forcing_band
            ksq = spectral.ksq(k0, k1, k2)
            band = (ksq >= klo * klo) & (ksq < khi * khi)
            w = spectral.packed_hermitian_weights(self.FFT.N, Ur.device)
            ntot = float(np.prod([int(n) for n in self.FFT.N]))
            Eb = self.FFT._all_reduce(
                torch.sum(torch.where(band, w * (Ur * Ur + Ui * Ui), 0.0))
                / (2.0 * ntot * ntot))
            alpha = torch.where(Eb > 0, self.forcing_rate / (2.0 * Eb), 0.0)
            dU[0].add_((alpha * band) * Ur)
            dU[1].add_((alpha * band) * Ui)
        return dU

    def energy(self, U_hat) -> float:
        """Mean kinetic energy 0.5 <|u|²>: in physical space, or the
        Parseval sum for the packed layout."""
        if self.spectral_layout == "packed":
            return self.energy_packed(U_hat)
        U = self._bwd(U_hat)
        e = 0.5 * self.staged_mean(torch.sum(U * U, dim=0))
        if self.FFT.P > 1:      # equal blocks: the mean of the ranks' means
            e = self.FFT._all_reduce(e) / self.FFT.P
        return float(e)

    def rhs_with_state(self, U_hat):
        """The right-hand side with the stored wavenumber vectors, in the
        solver's layout."""
        return self._rhs_state(U_hat, *self._step_args())
