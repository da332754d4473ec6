"""``planar_irfft_launch``: c2r along the last axis from the first
``nf_in`` columns of a planar pair of ``ld`` columns.

args: xr, xi, y, tw_h, tw_n, rows, n, nf_in, ld, scale.  Reads nf_in
columns of the pair (the rest are absent by contract), writes (rows, n)
reals."""

from yardstick import F32, fft_flops


def work(args):
    rows, n, nf_in = args[5], args[6], args[7]
    return 2 * F32 * rows * nf_in + F32 * rows * n, \
        fft_flops(rows * n, n, real=True)
