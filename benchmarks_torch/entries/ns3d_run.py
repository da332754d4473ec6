"""Entry ``ns3d_run``: a DNS job's loop, ``NavierStokes3D.run(U, k,
monitor_every=k)`` on ``slab.R2C``, with the energy read back to the host
every k steps as a DNS logs it.  One unit is one RK4 step.

Traffic parameters: ``spectral_layout`` ("packed" or "complex"),
``dealias`` ("2/3-rule" or "3/2-rule") and ``monitor_every`` (k).
Configuration: ``N``, ``L``, ``nu``, ``dt``, ``integrator``,
``precision`` and the ``perturbation`` (``kmax``, ``amplitude``).

The initial state is the Taylor–Green vortex plus a divergence-free
perturbation drawn from the seed on the card: random modes in |k| ≤ kmax
(a small block of the spectrum, Hermitian on the k2 = 0 plane) scaled to
``amplitude`` of the vortex's rms velocity.  The check runs the plain
float64 reference (``reference/ns3d.py``) over the last chunk of k steps
from the state the program started it from, and compares the program's
state, by its largest gap and by its L2 norm.  (The logged energy is not
compared: a TF32 control reads it no worse than the program.)
"""

import math

import numpy as np
import torch

from reference import layouts
from reference.ns3d import NS3D


def perturbation(N, kmax, seed, device):
    """A divergence-free spectral block (3, 2·kmax + 1, 2·kmax + 1,
    kmax + 1) complex128 and its (k0, k1) index vectors in fft layout:
    modes with |k| ≤ kmax, Hermitian on the k2 = 0 plane, of unit
    Parseval energy (0.5 Σ w |δ|² / ntot² = 1)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    m = 2 * kmax + 1
    kf = torch.arange(-kmax, kmax + 1, dtype=torch.float64, device=device)
    kh = torch.arange(kmax + 1, dtype=torch.float64, device=device)
    K = (kf[:, None, None], kf[None, :, None], kh[None, None, :])
    d = torch.randn((2, 3, m, m, kmax + 1), generator=g, dtype=torch.float64,
                    device=device)
    d = torch.complex(d[0], d[1])
    ksq = K[0] ** 2 + K[1] ** 2 + K[2] ** 2
    d = d * ((ksq <= kmax * kmax) & (ksq > 0))
    # Hermitian k2 = 0 plane: δ(−k0, −k1) = conj δ(k0, k1); the block is
    # centred, so −k is the flip
    p0 = d[..., 0]
    d[..., 0] = 0.5 * (p0 + torch.flip(p0, (1, 2)).conj())
    div = (K[0] * d[0] + K[1] * d[1] + K[2] * d[2]) / torch.where(
        ksq == 0, 1.0, ksq)
    d = d - torch.stack([K[0] * div, K[1] * div, K[2] * div])
    w = torch.where(K[2] == 0, 1.0, 2.0)
    ntot = float(math.prod(N))
    e = 0.5 * torch.sum(w * (d.real ** 2 + d.imag ** 2)) / ntot ** 2
    idx = torch.arange(-kmax, kmax + 1, device=device) % N[0], \
        torch.arange(-kmax, kmax + 1, device=device) % N[1]
    return d / torch.sqrt(e), idx


def add_perturbation(U, N, kmax, amplitude, seed):
    """U (complex (3, N0, N1, Nf), or packed (2, 3, N0, N1, h)) plus the
    seed's perturbation with amplitude² of the Taylor–Green energy (1/8)
    as its energy; returns a new state."""
    d, (i0, i1) = perturbation(N, kmax, seed, U.device)
    d = d * math.sqrt(amplitude ** 2 / 8.0)
    U = U.clone()
    sel = (slice(None), i0[:, None, None], i1[None, :, None],
           torch.arange(kmax + 1, device=U.device)[None, None, :])
    if U.is_complex():
        U[sel] += d.to(U.dtype)
    else:
        # packed: column 0 is X0 + i·X_Nyq with X_Nyq = 0 here
        U[0][sel] += d.real.to(U.dtype)
        U[1][sel] += d.imag.to(U.dtype)
    return U


class Entry:
    unit = "step"

    def __init__(self, cfg, traffic, seed, device, system="program",
                 comm=None):
        if comm is not None:
            raise ValueError("ns3d_run runs on one card")
        self.cfg, self.device = cfg, device
        self.N = tuple(int(n) for n in cfg["N"])
        self.k = self.checked_units = int(traffic["monitor_every"])
        self.layout = traffic["spectral_layout"]
        self.dealias = traffic["dealias"]
        if system == "program":
            from mpifft4py_tpu_torch import models
            from mpifft4py_tpu_torch.slab import R2C
            FFT = R2C(np.array(self.N), np.array(cfg["L"], dtype=float),
                      None, {"float32": "single"}[cfg["precision"]],
                      device=device)
            self.solver = getattr(models, cfg["model"])(
                FFT, nu=cfg["nu"], dt=cfg["dt"], dealias=self.dealias,
                spectral_layout=self.layout, integrator=cfg["integrator"])
        elif system == "control":
            self.solver = self._reference("tf32")
        else:
            raise ValueError(f"unknown system {system!r}")
        U = (self.solver.taylor_green() if system == "program"
             else self.solver.taylor_green(device))
        p = cfg["perturbation"]
        self.state = add_perturbation(U, self.N, int(p["kmax"]),
                                      float(p["amplitude"]), seed)
        self.prev = None

    def _reference(self, precision):
        c = self.cfg
        if c["model"] != "NavierStokes3D" or c["integrator"] != "RK4":
            raise ValueError("the reference is NS3D with RK4")
        return NS3D(self.N, c["L"], c["nu"], c["dt"], self.dealias,
                    precision, self.device)

    def warm_up(self):
        """One step and one energy: every shape of the loop."""
        self.state, e = self.solver.run(self.state, 1, monitor_every=1)
        float(e[-1])

    def chunk(self):
        """k steps of the timed path; ends with the energy on the host."""
        self.prev = None
        nxt, e = self.solver.run(self.state, self.k, monitor_every=self.k)
        float(e[-1])
        self.prev, self.state = self.state, nxt
        return self.k

    def check(self):
        """The reference's k steps from the last chunk's start, against
        the program's end state."""
        U_in = layouts.to_complex(self.prev)
        out = self.state
        self.solver = self.prev = self.state = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        ref = self._reference("float64")
        U_ref, _ = ref.run(U_in, self.k, self.k)
        del U_in
        # compared a component at a time
        err = top = l2e = l2r = 0.0
        for c in range(3):
            o = layouts.to_complex(out[:, c:c + 1] if not out.is_complex()
                                   else out[c:c + 1])[0]
            d = (o - U_ref[c]).abs()
            err = max(err, float(d.max()))
            top = max(top, float(U_ref[c].abs().max()))
            l2e += float(torch.sum(d * d))
            l2r += float(torch.sum(U_ref[c].abs() ** 2))
        return {"state_err": err / top, "state_l2": math.sqrt(l2e / l2r)}
