"""Entry ``r2c_roundtrip``: a transform caller's loop, ``fu = R2C.fftn(u)``
then ``R2C.ifftn(fu)``, back to back, synchronised every ``batch`` round
trips.  One unit is one round trip.

Traffic parameters: ``batch``.  Configuration: ``N``, ``L``,
``precision``, ``dealias``.  The input is a real N(0, 1) field drawn from
the seed on the card.  The check compares the last round trip's spectrum
with the plain float64 transform (``reference/r2c.py``) and its result
with the input.
"""

import numpy as np
import torch

from reference.r2c import R2C as PlainR2C


class Entry:
    unit = "roundtrip"
    checked_units = 1

    def __init__(self, cfg, traffic, seed, device, system="program",
                 comm=None):
        if comm is not None:
            raise ValueError("r2c_roundtrip runs on one card")
        self.N = tuple(int(n) for n in cfg["N"])
        self.batch = int(traffic["batch"])
        if system == "program":
            from mpifft4py_tpu_torch.slab import R2C
            self.fft = R2C(np.array(self.N), np.array(cfg["L"], dtype=float),
                           None, {"float32": "single"}[cfg["precision"]],
                           device=device)
            self.dealias = cfg["dealias"]
        elif system == "control":
            self.fft = PlainR2C(self.N, "tf32")
            self.dealias = None
        else:
            raise ValueError(f"unknown system {system!r}")
        g = torch.Generator(device=device).manual_seed(int(seed))
        self.u = torch.randn(self.N, generator=g, dtype=torch.float32,
                             device=device)
        self.fu = self.v = None

    def _roundtrip(self):
        if self.dealias is None:
            self.fu = self.fft.fftn(self.u)
            self.v = self.fft.ifftn(self.fu)
        else:
            self.fu = self.fft.fftn(self.u, dealias=self.dealias)
            self.v = self.fft.ifftn(self.fu, dealias=self.dealias)

    def _sync(self):
        if self.u.is_cuda:
            torch.cuda.synchronize(self.u.device)

    def warm_up(self):
        self._roundtrip()
        self._sync()

    def chunk(self):
        for _ in range(self.batch):
            self._roundtrip()
        self._sync()
        return self.batch

    def check(self):
        """The last round trip: its spectrum against the float64 rfftn of
        the input, its result against the input."""
        fu, v, u = self.fu, self.v, self.u
        self.fft = self.fu = self.v = None
        ref = PlainR2C(self.N, "float64").fftn(u)
        fwd = float((fu.to(ref.dtype) - ref).abs().max()
                    / ref.abs().max())
        del ref
        rt = float((v - u).abs().max() / u.abs().max())
        return {"fwd_err": fwd, "rt_err": rt}
