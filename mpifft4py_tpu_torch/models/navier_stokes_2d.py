"""2D incompressible Navier–Stokes in vorticity form over ``line.R2C``.

Port of ``mpifft4py_tpu/models/navier_stokes_2d.py``:

    ∂ω/∂t + u·∇ω = ν ∇²ω,  u = ∇⊥ψ,  ∇²ψ = −ω;
    ψ̂ = ω̂/|k|²,  û = (i k_y ψ̂, −i k_x ψ̂), the nonlinear term dealiased.

Two spectral layouts:

* ``"complex"`` (default): ω̂ is a complex (N0, Nf) tensor through
  ``FFT.forward_fn``/``backward_fn`` (``torch.fft``, as the reference's
  default P == 1 route is ``jnp.fft``).  The right-hand side's four
  inverses ride one batched call.
* ``"packed"``: ω̂ is the packed-Hermitian planar float32 pair, carried as
  ONE (2, N0, N1/2) tensor (``[0]``/``[1]`` the re/im planes), so the
  integrators of ``SpectralSolver._advance`` step it unchanged.  Under the
  2/3 rule the lane-0 Nyquist rider is zero, and every transform runs on
  the hand-written kernels: the packed z r2c/c2r and ``fft_axis`` on x.
  Where ``ops.zdif.zdif_active(N1)`` holds (N1 ∈ {512, 768, 1024}) the k1
  lanes live in ``zdif_perm`` order, the z stages are rows 17–18
  (``rfft_last_zdif``/``irfft_last_zdif``) and the wavenumber vector is
  permuted to match, as in the reference.  Its gate is the reference's
  (P == 1, the 2/3 rule, (N1/2) % 128 == 0, N0 = r·m with r <= 8 and
  m >= 8, i.e. ``supported_c2c(N0)``) and ``supported_r2c(N1)`` (even
  N1 <= 2048, where the z kernels stop, as the reference's do).

The reference is not a ``SpectralSolver``: it borrows ``_advance`` and
``staged_mean``, and so does the port.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import fft3d as p3
from ..ops import zdif as zd
from ..utils.spectral import dealias_cutoffs
from .navier_stokes import INTEGRATORS, SpectralSolver

__all__ = ["NavierStokes2D"]


class NavierStokes2D:
    def __init__(self, FFT, nu: float, dt: float,
                 dealias: Optional[str] = "2/3-rule", integrator: str = "RK4",
                 spectral_layout: str = "complex"):
        self.FFT = FFT
        self.nu = float(nu)
        self.dt = float(dt)
        self.dealias = dealias
        if integrator not in INTEGRATORS:
            raise ValueError(f"integrator must be one of {INTEGRATORS}, "
                             f"got {integrator!r}")
        self.integrator = integrator
        if spectral_layout not in ("complex", "packed"):
            raise ValueError(f"spectral_layout must be 'complex' or 'packed', "
                             f"got {spectral_layout!r}")
        if spectral_layout == "packed":
            self._validate_packed()
        self.spectral_layout = spectral_layout
        K = FFT.get_scaled_local_wavenumbermesh()      # (2, N0, Nfp)
        K2 = torch.sum(K * K, dim=0)
        self.K = K
        self.K2 = K2
        self.K2_inv = torch.where(K2 == 0, 0.0,
                                  1.0 / torch.where(K2 == 0, 1.0, K2))
        self._fwd = FFT.forward_fn(dealias=dealias)
        self._bwd = FFT.backward_fn()
        self._bwd_nl = (FFT.backward_fn(dealias) if dealias == "3/2-rule"
                        else self._bwd)
        if spectral_layout == "packed":
            self._init_packed()

    # -- packed layout ---------------------------------------------------------

    def _validate_packed(self):
        FFT = self.FFT
        n0, n1 = int(FFT.N[0]), int(FFT.N[1])
        r0, m0 = p3._factor(n0)
        if not (getattr(FFT, "P", 1) == 1 and self.dealias == "2/3-rule"
                and (n1 // 2) % 128 == 0 and r0 <= 8 and m0 >= 8):
            raise ValueError(
                "packed 2D layout needs P == 1, dealias='2/3-rule', "
                "(N1/2) % 128 == 0 and N0 = r·m with r <= 8, m <= 128 "
                "(the reference's planar-stage gate: N0 <= 1024 for powers "
                "of two)")
        if not p3.supported_r2c(n1):
            raise ValueError(
                f"packed 2D layout: N1 = {n1} is outside the z kernels' "
                f"envelope (even N1 <= 2048; the reference's gate has no "
                f"upper bound, but its kernels stop there too)")

    def _init_packed(self):
        """Factored scaled wavenumber vectors of the packed pair: k0 signed
        (N0,), k1 the lane wavenumbers (h,), permuted to zdif order where
        the DIF z stage is gated (lane l holds k = zdif_perm[l]), and the
        pair's 2/3 mask, built once."""
        N0, N1 = (int(n) for n in self.FFT.N)
        h = N1 // 2
        s = (2 * np.pi / np.asarray(self.FFT.L)).astype(np.float32)
        k0 = np.fft.fftfreq(N0, 1.0 / N0).astype(np.float32) * s[0]
        k1 = np.arange(h, dtype=np.float32)
        self._dif = zd.zdif_active(N1)
        if self._dif:
            k1 = k1[zd.zdif_perm(N1)]
        k1 = k1 * s[1]
        c = dealias_cutoffs(self.FFT.N)
        # the reference compares its float32 vectors with Python-float
        # cutoffs, which JAX casts to float32 first
        self._cut = tuple(float(np.float32(float(ci) * float(si)))
                          for ci, si in zip(c, s))
        self.k0 = torch.from_numpy(k0).to(self.FFT.device)
        self.k1 = torch.from_numpy(k1).to(self.FFT.device)
        self._keep = self._mask_pk(self.k0, self.k1)

    def _mask_pk(self, k0, k1):
        """The 2/3-rule mask (N0, h) of the packed pair."""
        return ((k0.abs()[:, None] < self._cut[0])
                & (k1[None, :] < self._cut[1]))

    def _purify2d(self, yr, yi):
        """Drop the Nyquist rider from packed lane 0 (the flip-conj runs
        along the one transformed full axis, k0), in place: ``yr``/``yi``
        are the forward's own tensors."""
        qr, qi = yr[..., 0], yi[..., 0]
        fr, fi = p3._flipconj(qr, qi, (qr.ndim - 1,))
        qr.copy_(0.5 * (qr + fr))
        qi.copy_(0.5 * (qi + fi))
        return yr, yi

    def _fwd_pk(self, w):
        """real (…, N0, N1) -> masked, purified packed pair (…, N0, h)."""
        w = w.to(torch.float32).contiguous()
        yr, yi = p3.rfft_last_packed(w, dif=True)
        yr, yi = p3.fft_axis_planar(yr, yi, axis=w.ndim - 2)
        yr, yi = self._purify2d(yr, yi)
        drop = ~self._keep
        return yr.masked_fill_(drop, 0), yi.masked_fill_(drop, 0)

    def _bwd_pk(self, pr, pi):
        yr, yi = p3.fft_axis_planar(pr.contiguous(), pi.contiguous(),
                                    axis=pr.ndim - 2, inverse=True)
        return p3.irfft_last_packed(yr, yi, int(self.FFT.N[1]), dif=True)

    def pack_state(self, w_hat):
        """complex (N0, Nf) -> the packed state (2, N0, h) in the layout's
        lane order (the Nyquist column folds into the lane-0 rider)."""
        nf = w_hat.shape[-1]
        qr, qi = p3.pack_plane0(w_hat[..., 0], w_hat[..., nf - 1])
        body = w_hat[..., 1:nf - 1]
        br = torch.cat([qr[..., None], body.real], dim=-1).to(torch.float32)
        bi = torch.cat([qi[..., None], body.imag], dim=-1).to(torch.float32)
        if self._dif:
            p = torch.from_numpy(zd.zdif_perm(int(self.FFT.N[1]))).to(
                br.device)
            br, bi = br[..., p], bi[..., p]
        return torch.stack([br, bi])

    def unpack_state(self, Wp):
        """The packed state (a (2, …) tensor or an (re, im) pair) -> complex
        (N0, Nf) (the diagnostic boundary)."""
        br, bi = Wp
        if self._dif:
            ip = torch.from_numpy(zd.zdif_iperm(int(self.FFT.N[1]))).to(
                br.device)
            br, bi = br[..., ip], bi[..., ip]
        p0, pny = p3.unpack_plane0(br, bi, axes=(br.ndim - 2,))
        body = torch.complex(br, bi)[..., 1:]
        return torch.cat([p0[..., None], body, pny[..., None]], dim=-1)

    def rhs_packed(self, Wp, k0, k1):
        """The right-hand side of the packed state ``Wp`` (a (2, N0, h)
        tensor or an (re, im) pair), as one (2, N0, h) tensor:
        4 inverse + 1 forward transform, all spectral algebra on float
        pairs (i·k multiplies are planar swaps).  The four inverses ride
        one batched (4, N0, h) chain: one x inverse and one z c2r."""
        wr, wi = Wp
        K0, K1 = k0[:, None], k1[None, :]
        K2 = K0 * K0 + K1 * K1
        K2i = torch.where(K2 == 0, 0.0, 1.0 / torch.where(K2 == 0, 1.0, K2))
        pr, pi = wr * K2i, wi * K2i
        # rows: u = ifft(i k1 ψ̂), v = ifft(−i k0 ψ̂), ω_x = ifft(i k0 ω̂),
        #       ω_y = ifft(i k1 ω̂)
        gr = torch.stack([-K1 * pi, K0 * pi, -K0 * wi, -K1 * wi])
        gi = torch.stack([K1 * pr, -K0 * pr, K0 * wr, K1 * wr])
        G = self._bwd_pk(gr, gi)                   # (4, N0, N1) physical
        ar, ai = self._fwd_pk(G[0] * G[2] + G[1] * G[3])
        nk = self.nu * K2
        return torch.stack([-ar - nk * wr, -ai - nk * wi])

    # -- shared machinery --------------------------------------------------------

    def vortex_pair(self):
        """Two counter-rotating Gaussian vortices; ω̂ in the solver's
        layout.  Each Gaussian is the product of exponentials of the 1-D
        coordinates (on the CPU, the first multithreaded float32
        transcendental of a process can be inaccurate in its last digits;
        1-D calls stay off that path)."""
        x, y = self.FFT._local_coords()
        L = 2 * np.pi
        gy = torch.exp(-(y - 0.5 * L) ** 2 / 0.05)[None, :]
        g1 = torch.exp(-(x - 0.4 * L) ** 2 / 0.05)[:, None]
        g2 = torch.exp(-(x - 0.6 * L) ** 2 / 0.05)[:, None]
        w = g1 * gy - g2 * gy
        if self.spectral_layout == "packed":
            return torch.stack(self._fwd_pk(w))
        return self._fwd(w)             # dealiased, as the packed state

    def rhs(self, w_hat, K, K2, K2i):
        psi_hat = w_hat * K2i
        u, v, wx, wy = self._bwd_nl(torch.stack([
            1j * K[1] * psi_hat, -1j * K[0] * psi_hat, 1j * K[0] * w_hat,
            1j * K[1] * w_hat]))
        adv = self._fwd(u * wx + v * wy)
        return -adv - self.nu * K2 * w_hat

    def _step_args(self):
        if self.spectral_layout == "packed":
            return (self.k0, self.k1)
        return (self.K, self.K2, self.K2_inv)

    def _rhs_state(self, V, *args):
        rhs = self.rhs_packed if self.spectral_layout == "packed" else self.rhs
        return rhs(V, *args)

    def ab2_state(self, w_hat):
        """(w_hat, f_prev) carry for integrator='AB2' (first step = Euler)."""
        if self.integrator != "AB2":
            raise ValueError("ab2_state is only meaningful with integrator='AB2'")
        return (w_hat, self._rhs_state(w_hat, *self._step_args()))

    def step(self, w_hat):
        args = self._step_args()
        return SpectralSolver._advance(
            self, lambda V: self._rhs_state(V, *args), w_hat)

    def run(self, state, nsteps: int):
        """``nsteps`` steps (a Python loop: PyTorch runs eagerly)."""
        for _ in range(nsteps):
            state = self.step(state)
        return state

    def enstrophy(self, w_hat) -> float:
        w = (self._bwd_pk(w_hat[0], w_hat[1])
             if self.spectral_layout == "packed" else self._bwd(w_hat))
        return float(0.5 * SpectralSolver.staged_mean(w * w))
