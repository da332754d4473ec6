"""``planar_rfft_launch``: r2c along the last axis into a planar pair of
``ld`` columns (the first ``nf`` the spectrum, the rest zeros).

args: x, yr, yi, tw_h, tw_n, rows, n, nf, ld, dbl, scale.  Reads (rows, n)
reals, writes the pair (rows, ld)."""

from yardstick import F32, fft_flops


def work(args):
    rows, n, ld = args[5], args[6], args[8]
    return F32 * rows * n + 2 * F32 * rows * ld, \
        fft_flops(rows * n, n, real=True)
