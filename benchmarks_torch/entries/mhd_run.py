"""Entry ``mhd_run``: an MHD DNS job's loop, ``MHD3D.run(UB, k,
monitor_every=k)`` on ``slab.R2C``, with the total (kinetic + magnetic)
energy read back to the host every k steps as a DNS logs it.  One unit is
one RK4 step; the loop, the warm-up and the chunks are ``ns3d_run``'s.

Traffic parameters: ``spectral_layout`` ("packed" or "complex"),
``dealias`` and ``monitor_every`` (k).  Configuration: ``N``, ``L``,
``nu``, ``eta``, ``dt``, ``b0``, ``integrator``, ``precision`` and the
``perturbation`` (``kmax``, ``amplitude``).

The initial state is the insulating Taylor–Green flow
(``MHD3D.taylor_green_mhd(b0)``) plus, on each field, ``ns3d_run``'s
divergence-free perturbation at ``amplitude`` of that field's rms (both
fields hold 1/8 of energy at b0 = 1/√3), u drawn from the seed and b from
the seed plus ``B_SEED``.  The check frees the program, runs the plain
float64 reference (``reference/mhd.py``) over the last chunk of k steps
from the state the program started it from, and compares all six
components: ``u_err`` and ``b_err``, each field's largest gap over its
largest coefficient, and ``state_l2``, the relative L2 gap of both.
"""

import math

import numpy as np
import torch

from entries import ns3d_run
from reference import layouts
from reference.mhd import MHD

B_SEED = 2 ** 40        # b's draw: beyond every seed u is drawn from


class Entry(ns3d_run.Entry):

    def __init__(self, cfg, traffic, seed, device, system="program",
                 comm=None):
        if comm is not None:
            raise ValueError("mhd_run runs on one card")
        self.cfg, self.device = cfg, device
        self.N = tuple(int(n) for n in cfg["N"])
        self.k = self.checked_units = int(traffic["monitor_every"])
        self.layout = traffic["spectral_layout"]
        self.dealias = traffic["dealias"]
        b0 = float(cfg["b0"])
        if system == "program":
            from mpifft4py_tpu_torch import models
            from mpifft4py_tpu_torch.slab import R2C
            FFT = R2C(np.array(self.N), np.array(cfg["L"], dtype=float),
                      None, {"float32": "single"}[cfg["precision"]],
                      device=device)
            self.solver = getattr(models, cfg["model"])(
                FFT, nu=cfg["nu"], eta=cfg["eta"], dt=cfg["dt"],
                dealias=self.dealias, spectral_layout=self.layout,
                integrator=cfg["integrator"])
            UB = self.solver.taylor_green_mhd(b0)
        elif system == "control":
            self.solver = self._reference("tf32")
            UB = self.solver.taylor_green_mhd(device, b0)
        else:
            raise ValueError(f"unknown system {system!r}")
        p = cfg["perturbation"]
        kmax, amp = int(p["kmax"]), float(p["amplitude"])
        ax = 0 if UB.is_complex() else 1
        self.state = torch.cat([
            ns3d_run.add_perturbation(UB.narrow(ax, 0, 3), self.N, kmax, amp,
                                      seed),
            ns3d_run.add_perturbation(UB.narrow(ax, 3, 3), self.N, kmax, amp,
                                      seed + B_SEED)], ax)
        self.prev = None

    def _reference(self, precision):
        c = self.cfg
        if c["model"] != "MHD3D" or c["integrator"] != "RK4":
            raise ValueError("the reference is MHD3D with RK4")
        return MHD(self.N, c["L"], c["nu"], c["eta"], c["dt"], self.dealias,
                   precision, self.device)

    def check(self):
        """The reference's k steps from the last chunk's start, against
        the program's end state, a component at a time."""
        U_in = layouts.to_complex(self.prev)
        out = self.state
        self.solver = self.prev = self.state = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        ref = self._reference("float64")
        U_ref, _ = ref.run(U_in, self.k, self.k)
        del U_in
        err, top = [0.0, 0.0], [0.0, 0.0]
        l2e = l2r = 0.0
        for c in range(6):
            o = layouts.to_complex(out[:, c:c + 1] if not out.is_complex()
                                   else out[c:c + 1])[0]
            d = (o - U_ref[c]).abs()
            f = c // 3                          # 0: u, 1: b
            err[f] = max(err[f], float(d.max()))
            top[f] = max(top[f], float(U_ref[c].abs().max()))
            l2e += float(torch.sum(d * d))
            l2r += float(torch.sum(U_ref[c].abs() ** 2))
        return {"u_err": err[0] / top[0], "b_err": err[1] / top[1],
                "state_l2": math.sqrt(l2e / l2r)}
