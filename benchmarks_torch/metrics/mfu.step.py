"""``mfu.step``: the RK4 step's nominal flops over its time, as a share of
the card's FP32 peak (67 TFLOP/s).  Nominal flops: the configuration's
real 3D transforms a step (``transforms_per_step``: 36 for NS3D, 3 inverse
for u, 3 for ω and 3 forward of u × ω in each of four right-hand sides)
× 2.5·M·log2 M, M the points of the grid they run on (N, or 3N/2 a side
under the 3/2 rule).  Counted from the grid, it reads the same whatever
implements the step; the time is the window's ``step_ms``."""

import math

from yardstick import mfu_percent


def read(rec):
    ms = rec.e2e.get("step_ms")
    if ms is None:
        return None
    cfg = rec.cell.cfg
    pad = 1.5 if rec.cell.traffic.get("dealias") == "3/2-rule" else 1.0
    M = math.prod(int(pad * int(n)) for n in cfg["N"])
    flops = cfg["transforms_per_step"] * 2.5 * M * math.log2(M)
    return mfu_percent(flops, ms * 1e-3)
