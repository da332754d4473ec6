"""``launches.step``: device kernels an RK4 step in the traced chunk, all
of them (hand-written or not)."""


def read(rec):
    seg = rec.segment
    if seg is None or not seg.kernels or not seg.units:
        return None
    return len(seg.kernels) / seg.units
