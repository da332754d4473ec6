"""The benchmark's fixed arithmetic: the card's peaks, FFT flop counts and
the roofline bound of one launch (copied from ``chip_smoke.py``'s
``fft_flops``/``bound``).

A launch's bound is the least time the card could take for it: the larger
of its bytes over the HBM bandwidth and its flops over the FP32 rate
outside the tensor cores.  Bytes count each input byte read once and each
output byte written once; flops are 5·n·log2(n) a complex transform of
length n and half that a real one.
"""

import math

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA's data sheet)
FP32_FLOPS_PER_S = 67e12       # H100 SXM FP32 outside the tensor cores
F32 = 4                        # bytes of a float32


def fft_flops(points, n, real=False):
    """Flops of ``points`` samples in transforms of length ``n``."""
    return (2.5 if real else 5.0) * points * math.log2(n)


def bound_s(nbytes, flops):
    """The launch's least time in seconds: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def mfu_percent(flops_per_unit, seconds_per_unit):
    """Share of the FP32 peak, in %, of ``flops_per_unit`` done in
    ``seconds_per_unit``."""
    return 100.0 * flops_per_unit / seconds_per_unit / FP32_FLOPS_PER_S
