"""``packed_rfft_launch``: packed r2c along the last axis.

args: x, yr, yi, tw_h, tw_n, rows, n.  Reads (rows, n) reals, writes the
packed pair (rows, n/2)."""

from yardstick import F32, fft_flops


def work(args):
    rows, n = args[5], args[6]
    return F32 * rows * n + 2 * F32 * rows * (n // 2), \
        fft_flops(rows * n, n, real=True)
