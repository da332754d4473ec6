"""``kernel_roofline.step``: the hand-written launches of the traced chunk
of RK4 steps, Σ of each launch's bound (``work/<entry>.py``) over Σ of its
kernels' device time, in %."""

from traced import kernel_roofline


def read(rec):
    return kernel_roofline(rec)
