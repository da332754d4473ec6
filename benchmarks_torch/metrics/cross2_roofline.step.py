"""``cross2_roofline.step``: the share of its roofline of MHD's own kernel
in the traced chunk, the ``cross_rfft_z`` launches with op 1 (A × B + C × D
of four physical stacks under the packed z r2c): Σ of each launch's bound
(``work/cross_rfft_z.py``) over Σ of its kernels' device time, in %.  A
segment without such launches gives nothing."""

import yardstick
from traced import _work

ENTRY, CROSS2 = "cross_rfft_z", 1


def read(rec):
    seg = rec.segment
    if seg is None:
        return None
    times = {}
    for _, s, i in seg.kernels:
        if i is not None and seg.launches[i][0] == ENTRY \
                and seg.launches[i][1][10] == CROSS2:
            times[i] = times.get(i, 0.0) + s
    spent = sum(times.values())
    if spent <= 0:
        return None
    work = _work(ENTRY)
    bound = sum(yardstick.bound_s(*work(seg.launches[i][1])) for i in times)
    return 100.0 * bound / spent
