"""Entry ``ns3d_slab``: ``ns3d_run``'s DNS loop with the slab over a group
of ranks, one card a rank: ``NavierStokes3D(slab.R2C(N, L, comm,
"single"), spectral_layout=...)`` stepping each rank's block, the
transposes and the plane-0 gathers over the group (``communication`` of
the configuration), the energy all-reduced and read back every k steps.
One unit is one RK4 step of the whole grid.

Traffic parameters and configuration as ``ns3d_run``'s, plus the
configuration's ``P`` (the group's size) and ``communication``.

The initial state is ``ns3d_run``'s: the Taylor–Green vortex plus the
seed's divergence-free perturbation (``ns3d_run.perturbation``), each rank
adding the modes of its k1 block, so the ranks' blocks make the state one
process builds.  The ranks leave ``warm_up`` and every chunk at one
instant of the host's clock (``_together``), so the run's per-rank test of
the window's end decides alike on every rank.  The check frees the
program's state, runs the plain float64 reference over the same group
(``reference/ns3d_slab.py``) for the last chunk's k steps from the state
the program started it from, and compares each rank's block; the largest
gaps and the sums of squares are reduced over the ranks.
"""

import gc
import math
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from entries.ns3d_run import perturbation
from reference.ns3d_slab import NS3DSlab, to_complex

SLACK_S = 0.002     # the rendezvous' margin over the all-reduce's latency


def add_block_perturbation(U, N, kmax, amplitude, seed, blk):
    """U (this rank's complex (3, N0, n1, Nf) or packed (2, 3, N0, n1, h)
    block, k1 in ``blk``) plus the modes of the seed's perturbation
    (``ns3d_run.add_perturbation``'s) that lie in the block."""
    d, (i0, i1) = perturbation(N, kmax, seed, U.device)
    d = d * math.sqrt(amplitude ** 2 / 8.0)
    mine = (i1 >= blk.start) & (i1 < blk.stop)
    d, j1 = d[:, :, mine], i1[mine] - blk.start
    U = U.clone()
    sel = (slice(None), i0[:, None, None], j1[None, :, None],
           torch.arange(kmax + 1, device=U.device)[None, None, :])
    if U.is_complex():
        U[sel] += d.to(U.dtype)
    else:
        U[0][sel] += d.real.to(U.dtype)
        U[1][sel] += d.imag.to(U.dtype)
    return U


class Entry:
    unit = "step"

    def __init__(self, cfg, traffic, seed, device, system="program",
                 comm=None):
        if comm is None:
            raise ValueError("ns3d_slab runs over a group of ranks: pass "
                             "comm")
        self.group, self.cfg, self.device = comm, cfg, device
        self.P, self.rank = dist.get_world_size(comm), dist.get_rank(comm)
        if self.P != int(cfg["P"]):
            raise ValueError(f"the configuration runs on P = {cfg['P']} "
                             f"ranks, the group has {self.P}")
        self.cuda = torch.device(device).type == "cuda"
        self.N = tuple(int(n) for n in cfg["N"])
        self.k = self.checked_units = int(traffic["monitor_every"])
        self.layout = traffic["spectral_layout"]
        self.dealias = traffic["dealias"]
        n1 = self.N[1] // self.P
        blk = slice(self.rank * n1, (self.rank + 1) * n1)
        if system == "program":
            from mpifft4py_tpu_torch import models
            from mpifft4py_tpu_torch.slab import R2C
            if self.cuda:
                # rank 0 builds the kernels; the others load its library
                if self.rank == 0:
                    from mpifft4py_tpu_torch.ops import _build
                    _build.load()
                dist.barrier(group=comm,
                             device_ids=[torch.cuda.current_device()])
            FFT = R2C(np.array(self.N), np.array(cfg["L"], dtype=float),
                      comm, {"float32": "single"}[cfg["precision"]],
                      communication=cfg["communication"], device=device)
            self.solver = getattr(models, cfg["model"])(
                FFT, nu=cfg["nu"], dt=cfg["dt"], dealias=self.dealias,
                spectral_layout=self.layout, integrator=cfg["integrator"])
            U = self.solver.taylor_green()
        elif system == "control":
            self.solver = self._reference("tf32")
            U = self.solver.taylor_green(device)
        else:
            raise ValueError(f"unknown system {system!r}")
        p = cfg["perturbation"]
        self.state = add_block_perturbation(U, self.N, int(p["kmax"]),
                                            float(p["amplitude"]), seed, blk)
        self.prev = None

    def _reference(self, precision):
        c = self.cfg
        if c["model"] != "NavierStokes3D" or c["integrator"] != "RK4":
            raise ValueError("the reference is NS3D with RK4")
        return NS3DSlab(self.N, c["L"], c["nu"], c["dt"], self.dealias,
                        precision, self.device, self.group)

    def _together(self):
        """Return on every rank at one instant of the host's monotonic
        clock (``time.perf_counter``, one clock for the processes of a
        host): the latest rank's reading plus ``SLACK_S``, agreed by an
        all-reduce."""
        t = torch.tensor([time.perf_counter() + SLACK_S],
                         dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        target = float(t[0])
        while time.perf_counter() < target:
            pass

    def warm_up(self):
        """One step and one energy: every shape of the loop; then the
        ranks meet."""
        self.state, e = self.solver.run(self.state, 1, monitor_every=1)
        float(e[-1])
        self._together()

    def chunk(self):
        """k steps of the timed path; ends with the energy on the host."""
        self.prev = None
        nxt, e = self.solver.run(self.state, self.k, monitor_every=self.k)
        float(e[-1])
        self.prev, self.state = self.state, nxt
        self._together()
        return self.k

    def check(self):
        """The reference's k steps from the last chunk's start, against
        the program's end state, block by block over the group."""
        prev, out = self.prev, self.state
        self.solver = self.prev = self.state = None
        gc.collect()
        t0 = time.perf_counter()
        if self.cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        ref = self._reference("float64")
        U = to_complex(prev, self.group)
        del prev
        for _ in range(self.k):
            U = ref.step(U)
        # compared a component at a time
        err = top = l2e = l2r = 0.0
        for c in range(3):
            o = to_complex(out[:, c:c + 1] if not out.is_complex()
                           else out[c:c + 1], self.group)[0]
            d = (o - U[c]).abs()
            err = max(err, float(d.max()))
            top = max(top, float(U[c].abs().max()))
            l2e += float(torch.sum(d * d))
            l2r += float(torch.sum(U[c].abs() ** 2))
        peak = torch.cuda.max_memory_allocated() if self.cuda else 0
        tops = torch.tensor([err, top, float(peak)], dtype=torch.float64,
                            device=self.device)
        sums = torch.tensor([l2e, l2r], dtype=torch.float64,
                            device=self.device)
        dist.all_reduce(tops, op=dist.ReduceOp.MAX, group=self.group)
        dist.all_reduce(sums, group=self.group)
        if self.rank == 0:
            print(f"check: float64 reference of {self.k} steps over "
                  f"{self.P} ranks, {time.perf_counter() - t0:.3f} s, peak "
                  f"{int(tops[2])} bytes (largest rank)", file=sys.stderr)
        return {"state_err": float(tops[0] / tops[1]),
                "state_l2": math.sqrt(float(sums[0] / sums[1]))}
