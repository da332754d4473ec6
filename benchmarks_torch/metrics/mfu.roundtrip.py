"""``mfu.roundtrip``: a round trip's nominal flops, 2 × 2.5·N·log2 N for
the grid's N points (a real forward and a real inverse), over the
window's ``roundtrip_ms``, as a share of the card's FP32 peak."""

import math

from yardstick import mfu_percent


def read(rec):
    ms = rec.e2e.get("roundtrip_ms")
    if ms is None:
        return None
    n = math.prod(int(x) for x in rec.cell.cfg["N"])
    return mfu_percent(2 * 2.5 * n * math.log2(n), ms * 1e-3)
