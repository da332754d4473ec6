"""``glue_share.step``: device time in kernels that no hand-written launch
issued (torch elementwise, ``cat``, copies, reductions) over the device's
busy time in the traced chunk, in %."""


def read(rec):
    seg = rec.segment
    if seg is None or seg.busy_s <= 0:
        return None
    glue = sum(s for _, s, i in seg.kernels if i is None)
    return 100.0 * glue / seg.busy_s
