"""``fft_axis_launch``: c2c along a non-last axis of a planar pair.

args: xr, xi, yr, yi, tw, pre, n, post, inverse.  Reads the (pre, n, post)
pair, writes one of the same shape."""

from yardstick import F32, fft_flops


def work(args):
    pre, n, post = args[5], args[6], args[7]
    points = pre * n * post
    return 4 * F32 * points, fft_flops(points, n)
