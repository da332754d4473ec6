"""``fft_x_epilogue_launch``: the x forward of a packed 3-stack with the
right-hand side's epilogue (mask, projection, curl or divergence, the
buoyancy rider, the diffusive term).

args: fr, fi, sr, si, tr, ti, k0, k1, k2, m0, m1, m2, yr, yi, tw, n, n1, h,
visc, mode, ri.  Reads the (3, n, n1, h) pair, the state pair (one
component in mode 2, div, else three) and the rider pair where ``tr`` is
given, writes a pair shaped as the state; the 1-D vectors are not
counted."""

from yardstick import F32, fft_flops


def work(args):
    tr, n, n1, h, mode = args[4], args[15], args[16], args[17], args[19]
    plane = n * n1 * h
    ns = 1 if mode == 2 else 3
    planes = 2 * 3 + 2 * ns + 2 * ns + (2 if tr is not None else 0)
    return F32 * plane * planes, fft_flops(3 * plane, n)
