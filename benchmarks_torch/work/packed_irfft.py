"""``packed_irfft_launch``: packed c2r along the last axis.

args: xr, xi, y, tw_h, tw_n, rows, n.  Reads the packed pair (rows, n/2),
writes (rows, n) reals."""

from yardstick import F32, fft_flops


def work(args):
    rows, n = args[5], args[6]
    return 2 * F32 * rows * (n // 2) + F32 * rows * n, \
        fft_flops(rows * n, n, real=True)
