"""``curl_ifft_x_launch``: the curl of a packed 3-stack with the x inverse,
and with ``with_state`` the state's own x inverse from the same pass.

args: ur, ui, k0, k1, k2, yr, yi, tw, n, n1, h, with_state, biot_savart.
Reads the (3, n, n1, h) pair, writes a (3 or 6, n, n1, h) pair; the 1-D
wavenumbers are not counted."""

from yardstick import F32, fft_flops


def work(args):
    n, n1, h, with_state = args[8], args[9], args[10], args[11]
    plane = n * n1 * h
    out = 6 if with_state else 3
    return 2 * F32 * plane * (3 + out), fft_flops(out * plane, n)
