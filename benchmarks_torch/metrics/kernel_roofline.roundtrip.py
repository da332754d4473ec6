"""``kernel_roofline.roundtrip``: as ``kernel_roofline.step``, over the
traced chunk of round trips."""

from traced import kernel_roofline


def read(rec):
    return kernel_roofline(rec)
