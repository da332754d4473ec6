"""``cross_rfft_z_launch``: a product of physical stacks with the packed z
r2c behind it: op 0 A × B, op 1 A × B + C × D, op 2 a_c·t.

args: a, b, c, d, yr, yi, tw_h, tw_n, rows, n, op.  Reads two (op 0), four
(op 1) or one and a third (op 2) (3, rows, n) stacks, writes the packed
pair (3, rows, n/2)."""

from yardstick import F32, fft_flops

STACKS_IN = {0: 2.0, 1: 4.0, 2: 4.0 / 3.0}


def work(args):
    rows, n, op = args[8], args[9], args[10]
    stack = 3 * rows * n
    return F32 * stack * STACKS_IN[op] + 2 * F32 * 3 * rows * (n // 2), \
        fft_flops(stack, n, real=True)
