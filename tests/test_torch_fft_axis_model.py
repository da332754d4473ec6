"""A float32 numpy model of ``fft_axis.cu`` (rows 1 and 19): its choice of
tile width, its persistent walk over column tiles, its split of each
tile into 16-byte or single-value copies, and its column-fastest last
stage.

The CUDA kernel (``fft_axis_kernel`` in
``mpifft4py_tpu_torch/ops/csrc/fft_axis.cu``) runs only on the card.  The
parts of it that are index arithmetic a CPU can hold to account:

- **The tile width.**  ``tile_cols`` picks T, a power of two, from (n,
  pre, post, the value's bytes): the most columns with n·T <= kAxisTile,
  widened (n·T <= kAxisMaxTile) to a 32-byte sector a row segment, or 64
  bytes where the rows start off the grid, at most ``post`` rounded up to
  a power of two (but a 16-byte unit), then fewer, down to that width,
  while the tiles would not give every multiprocessor two.  The model repeats it and checks the launch it gives (threads,
  shared memory) over the envelope, and the main path's widths.
- **The walk and the copies.**  Tile t of the persistent grid is (p, q0) =
  divmod(t, ceil(post/T)) with w = min(T, post − q0) columns; a plane's
  row segment r starts at value g0 + r·post.  ``load_cols`` and
  ``store_cols`` move a plane's tile in 16-byte chunks (cp.async in, a
  16-byte store out) where every segment starts on the 16-byte grid and
  spans whole chunks, else value by value.  The model walks every tile of
  a stack for bases 0–3 values off the grid, in both layouts, and checks
  that every input and output value is covered exactly once, that every
  16-byte copy is aligned on both sides and every copy lies inside its
  slot, that an aligned tensor (base and row pitch on the grid) goes
  wholly in 16-byte copies, its ragged last tiles too, and that row 19's
  1032-byte rows go value by value.
- **The column-fastest last stage.**  ``stage_fast_cols`` takes butterfly
  b as (k, c) = divmod(b, w) and writes output (c, k + q·Ns); after a
  pair-sum stage the kernel stages the tile as (c, k) = (e mod T, e / T).
  The model runs the plan's other stages with
  tests/test_torch_prime_stage.py's float32 model, then the last stage in
  the kernel's thread order into a slot of pitch T, stores through the
  walk and holds the result against numpy's float64 FFT (1e-5 of max
  |X|) and in a round trip (1e-6 of max |x|), the kernel's tolerances on
  the card, at lengths with radix-2/3/4/5/7 last stages and with primes
  >= 11 (the pair-sum stage last).

Run on the CPU (seconds):

    python -m pytest tests/test_torch_fft_axis_model.py -q
"""

import numpy as np
import pytest

from mpifft4py_tpu_torch.ops.fft3d import supported_c2c
from test_torch_packed import _one_torch_thread  # noqa: F401
from test_torch_prime_stage import make_plan, pairsum_stage, \
    register_stage, twiddles

F32 = np.float32
K_AXIS_TILE = 4096       # fft_axis.cu kAxisTile
K_AXIS_MAX_TILE = 8192   # fft_axis.cu kAxisMaxTile
K_WIDE = 64              # fft_axis.cu kWide: bytes a segment off the grid
SMS = 132                # an H100 SXM's multiprocessors
MAX_SMEM = 232448        # an H100 block's opt-in shared memory (bytes)
SM_SMEM = 233472         # an H100 multiprocessor's shared memory (bytes)
BLOCK_RESERVED = 1024    # bytes the runtime reserves a block


def mixed(n):
    """``fftblock::mixed_plan``: a radix above 4."""
    return max(make_plan(n)) > 4


def tile_cols(n, pre, post, kB, sms=SMS):
    """``tile_cols`` of fft_axis.cu: T, the columns a tile."""
    unit = 16 // kB
    seg = K_WIDE if (post * kB) % 16 else 32    # bytes a segment at least
    T = unit
    while 2 * T * n <= K_AXIS_TILE:
        T *= 2
    while T * kB < seg and 2 * T * n <= K_AXIS_MAX_TILE:
        T *= 2
    while T > unit and T // 2 >= post:
        T //= 2
    while T * kB > seg and pre * -(-post // T) < 2 * sms:
        T //= 2
    return T


def launch(n, pre, post, kB):
    """(T, threads, shared memory bytes, tiles) of ``launch_instance``."""
    T = tile_cols(n, pre, post, kB)
    kE = 8 if mixed(n) else 16
    threads = -(-n * T // (kE * 32)) * 32
    smem = 4 * 4 * n * T + 8 * n * T + 16
    return T, threads, smem, pre * -(-post // T)


# -- the walk ----------------------------------------------------------------

def tiles_of(pre, n, post, T):
    """(g0, w) of every tile t = p·tpp + q: the first value of its rows
    (p, 0, q0) and its columns."""
    tpp = -(-post // T)
    t = np.arange(pre * tpp)
    p, q = np.divmod(t, tpp)
    q0 = q * T
    return p * n * post + q0, np.minimum(T, post - q0)


def whole_chunks(base, g0, post, w, kB):
    """``whole_chunks``: the plane's tile goes in 16-byte chunks (every
    segment on the grid, w values a multiple of 16 bytes)."""
    return (post * kB) % 16 == 0 and (w * kB) % 16 == 0 and \
        (base + g0 * kB) % 16 == 0


def walk(pre, n, post, kB, bases, T):
    """fft_axis.cu's ``load_cols``/``store_cols`` over every tile of a
    stack: each plane's coverage of its (pre, n, post) values, the 16-byte
    copies and the single-value copies as arrays of (global byte address,
    slot byte offset), and per tile whether any value went singly."""
    unit = 16 // kB                  # values a 16-byte chunk
    PL = n * T * 4                   # bytes a plane of a slot (planar)
    cov = [np.zeros(pre * n * post, int) for _ in bases]
    whole, single, singly = [], [], []
    r = np.arange(n)[:, None]
    for g0, w in zip(*tiles_of(pre, n, post, T)):
        any_single = False
        for i, base in enumerate(bases):
            chunks = whole_chunks(base, g0, post, w, kB)
            c = np.arange(0, w, unit if chunks else 1)[None, :]
            g = g0 + r * post + c                        # (n, copies)
            copies = np.stack([(base + g * kB).ravel(),
                               (i * PL + (r * T + c) * kB).ravel()], -1)
            (whole if chunks else single).append(copies)
            span = unit if chunks else 1
            np.add.at(cov[i], (g[..., None] + np.arange(span)).ravel(), 1)
            any_single |= not chunks
        singly.append(any_single)
    empty = np.zeros((0, 2), int)
    return (cov, np.concatenate(whole or [empty]),
            np.concatenate(single or [empty]), np.array(singly))


def slot_bytes(n, T):
    return 2 * 4 * n * T               # a slot: two planes or one of float2


def _check_walk(pre, n, post, kB, bases):
    T = tile_cols(n, pre, post, kB)
    assert (T * kB) % 16 == 0 and T & (T - 1) == 0
    cov, whole, single, singly = walk(pre, n, post, kB, bases, T)
    assert all((cv == 1).all() for cv in cov)
    for copies, size in ((whole, 16), (single, kB)):
        addr, off = copies[:, 0], copies[:, 1]
        assert (addr % size == 0).all() and (off % size == 0).all()
        assert (off >= 0).all() and (off + size <= slot_bytes(n, T)).all()
    return T, whole, singly


# (pre, n, post, kB): the main path's stages cut in depth (row 1's x stage
# with fewer columns, the y stage, the 3/2 rule's n = 384, row 19's y
# stage, NS2D's x stage), small posts (1, 5, 129, 130), a prime stage
# (1016) and the smallest n
WALK_CASES = [(1, 256, 4096, 4), (16, 256, 128, 4), (4, 384, 384, 4),
              (8, 256, 129, 8), (1, 1024, 512, 4), (3, 256, 1, 4),
              (3, 256, 5, 8), (2, 256, 129, 4), (2, 256, 130, 4),
              (2, 256, 130, 8), (3, 1016, 5, 4), (1, 2, 129, 8),
              (2, 640, 20, 4), (3, 40, 33, 8)]


@pytest.mark.parametrize("mis", [0, 1, 2, 3])
@pytest.mark.parametrize("pre,n,post,kB", WALK_CASES)
def test_walk_covers_every_value_once(pre, n, post, kB, mis):
    """Bases `mis` values off the grid (complex64: its 8-byte values, so
    mis 2 and 3 fall back on it or one value off), the planar im plane
    off by one more (an ``out=`` view into a peer buffer may start
    anywhere a float does)."""
    bases = ([8 * (mis % 2)] if kB == 8 else
             [4 * mis, 4 * ((mis + 1) % 4)])
    _check_walk(pre, n, post, kB, bases)


@pytest.mark.parametrize("pre,n,post,kB", [(1, 256, 4096, 4),
                                           (16, 256, 128, 4),
                                           (4, 384, 384, 4),
                                           (1, 1024, 512, 4),
                                           (2, 256, 130, 8),
                                           (3, 40, 100, 4),
                                           (2, 256, 132, 4)])
def test_aligned_tensor_goes_by_whole_chunks(pre, n, post, kB):
    """Aligned bases and a row pitch on the grid: every value goes in a
    16-byte copy, a ragged last tile's too (its width is a multiple of the
    pitch's 16-byte unit, as post is)."""
    bases = [0] if kB == 8 else [0, 0]
    T, _, singly = _check_walk(pre, n, post, kB, bases)
    _, w = tiles_of(pre, n, post, T)
    assert not singly.any() and (post % T == 0 or (w < T).any())


def test_row19_rows_off_the_grid():
    """Row 19, complex64 (256, 256, 129) along axis 1: 1032-byte rows, so
    every other segment starts 8 bytes off the grid and every tile goes
    value by value (neighbouring threads on neighbouring values); each
    pre's last tile has one column and transforms only it."""
    pre, n, post = 256, 256, 129
    T = tile_cols(n, pre, post, 8)
    assert T == 16 and -(-post // T) == 9
    g0, w = tiles_of(pre, n, post, T)
    assert sorted(set(w.tolist())) == [1, 16] and (w == 1).sum() == pre
    cov, whole, single, singly = walk(2, n, post, 8, [0], T)
    assert (cov[0] == 1).all() and singly.all()
    assert len(whole) == 0 and len(single) == 2 * n * post


def test_main_path_tiles():
    """T, threads and blocks a multiprocessor at the main path's shapes:
    row 1 and the y stages 16 columns (64-byte segments a plane), 256
    threads, two blocks a multiprocessor; row 19 16 (128 bytes); n = 384
    8, but 16 (64 bytes) on the 3/2 rule's y stage, whose 516-byte rows
    start off the grid; NS2D's x stage and the widened plans 8 (one
    sector), one block."""
    for (pre, n, post, kB), want in (
            ((1, 256, 32768, 4), (16, 256, 2)),
            ((256, 256, 128, 4), (16, 256, 2)),
            ((768, 256, 128, 4), (16, 256, 2)),
            ((256, 256, 129, 8), (16, 256, 2)),
            ((1, 384, 147456, 4), (8, 192, 2)),
            ((384, 384, 384, 4), (8, 192, 2)),
            ((1, 1024, 512, 4), (8, 512, 1)),
            ((1, 640, 32768, 4), (8, 640, 1)),
            ((1, 1016, 32768, 4), (8, 1024, 1)),
            ((1152, 384, 129, 4), (16, 384, 1))):
        T, threads, smem, tiles = launch(n, pre, post, kB)
        assert smem <= MAX_SMEM
        per_sm = SM_SMEM // (smem + BLOCK_RESERVED)
        assert (T, threads, min(per_sm, 2)) == want, (pre, n, post, kB)


@pytest.mark.parametrize("kB", [4, 8])
def test_launch_fits_over_the_envelope(kB):
    """Every n the wrappers take (planar: ``supported_c2c``; complex64:
    2..1024), with posts from 1 to 32768 and pre 1, 3, 256: the tile's
    threads fit the instance's launch bounds and hold its values, shared
    memory fits a block, a segment spans a 32-byte sector (64 bytes where
    rows start off the grid) unless ``post`` is narrower or the tile would
    pass kAxisMaxTile, and a slot's plane is a whole number of 16-byte
    steps."""
    ns = range(2, 1025) if kB == 8 else [n for n in range(2, 1025)
                                         if supported_c2c(n)]
    for n in ns:
        kE = 8 if mixed(n) else 16
        for pre in (1, 3, 256):
            for post in (1, 3, 5, 129, 130, 4096, 32768):
                T, threads, smem, _ = launch(n, pre, post, kB)
                assert n * T <= K_AXIS_MAX_TILE
                assert threads * kE >= n * T
                assert threads <= K_AXIS_MAX_TILE // kE
                assert smem <= MAX_SMEM
                seg = K_WIDE if (post * kB) % 16 else 32
                assert (T * kB >= seg or T >= post or
                        2 * T * n > K_AXIS_MAX_TILE), (n, pre, post, T)
                # the landing pass moves a plane's floats 16 bytes a step
                assert (n * T * kB // 4) % 4 == 0


# -- the kernel end to end: copies, stages, the column-fastest last stage -----

def last_stage_cols(s, n, w, T, R, sign, scale, slot):
    """``stage_fast_cols`` into the slot: butterfly b = (k, c) with k = b
    / w, c = b mod w, inputs s[(k + t·Ns)·T + c] times tw[t·k], the R-point
    DFT, output q to slot[(k + q·Ns)·T + c]; returns the write counts."""
    Ns = n // R
    b = np.arange(Ns * w)
    k, c = np.divmod(b, w)
    twr, twi = twiddles(n, sign)
    v = np.stack([s[(k + t * Ns) * T + c] for t in range(R)])
    tw = (twr[np.outer(np.arange(R), k)] + 1j * twi[np.outer(np.arange(R),
                                                             k)])
    v = (v * tw.astype(np.complex64)).astype(np.complex64)
    ang = sign * 2.0 * np.pi * np.outer(np.arange(R), np.arange(R)) / R
    y = (np.exp(1j * ang).astype(np.complex64) @ v).astype(np.complex64)
    writes = np.zeros(n * T, int)
    for q in range(R):
        e = (k + q * Ns) * T + c
        slot[e] = y[q] * F32(scale)
        np.add.at(writes, e, 1)
    return writes


def kernel_model(x, pre, n, post, inverse, kB):
    """The kernel on complex (pre·n·post,) values x: every tile loaded
    into a slot of pitch T (the walk checks how), all but the last stage
    by the float32 model, the last stage in the kernel's order (or, after
    a pair-sum stage, the pass over the tile), stored back.  Returns the
    output and each output value's write count."""
    T = tile_cols(n, pre, post, kB)
    sign = 1 if inverse else -1
    scale = 1.0 / n if inverse else 1.0
    plan = make_plan(n)
    fused = plan[-1] <= (7 if mixed(n) else 4)
    twr, twi = twiddles(n, sign)
    y = np.full(x.shape, np.nan, np.complex64)
    count = np.zeros(x.shape, int)
    r = np.arange(n)
    for g0, w in zip(*tiles_of(pre, n, post, T)):
        w = int(w)
        g = g0 + r * post
        # load: every value of the tile at slot index r·T + c
        slot = np.zeros(n * T, np.complex64)
        idx = (r[:, None] * T + np.arange(w)[None, :]).ravel()
        slot[idx] = x[(g[:, None] + np.arange(w)[None, :]).ravel()]
        cols = slot.reshape(n, T)[:, :w]
        xr, xi = cols.real.astype(F32), cols.imag.astype(F32)
        Ns = 1
        for R in plan[:-1] if fused else plan:
            if R >= 11:
                xr, xi = pairsum_stage(xr, xi, Ns, R, twr, twi)
            else:
                xr, xi = register_stage(xr, xi, Ns, R, sign, twr, twi)
            Ns *= R
        work = np.zeros(n * T, np.complex64)
        work.reshape(n, T)[:, :w] = xr + 1j * xi
        out = np.zeros(n * T, np.complex64)
        if fused:
            writes = last_stage_cols(work, n, w, T, plan[-1], sign, scale,
                                     out)
        else:                 # put(e mod T, e / T, s[e]) for columns < w
            e = np.arange(n * T)
            e = e[(e & (T - 1)) < w]
            k, c = e >> (T.bit_length() - 1), e & (T - 1)
            out[k * T + c] = work[e] * F32(scale)
            writes = np.zeros(n * T, int)
            np.add.at(writes, k * T + c, 1)
        mine = writes.reshape(n, T)[:, :w]
        assert (mine == 1).all() and (writes.reshape(n, T)[:, w:] == 0).all()
        dst = (g[:, None] + np.arange(w)[None, :]).ravel()
        y[dst] = out[idx]
        np.add.at(count, dst, 1)
    return y, count


# (pre, n, post): register last stages (radix 4: 256, 16; radix 2: 8, 32;
# radix 3: 384, 12; radix 5: 640, 40; radix 7: 112, 28), the pair-sum
# stage last (129 = 3·43, 121 = 11², 1016 = 8·127, 11 alone)
MODEL_CASES = [(1, 256, 5), (3, 16, 129), (2, 8, 130), (1, 32, 1),
               (2, 384, 5), (3, 12, 33), (1, 640, 3), (2, 40, 129),
               (1, 112, 20), (3, 28, 5), (2, 129, 5), (1, 121, 3),
               (1, 1016, 2), (3, 11, 130)]


@pytest.mark.parametrize("kB", [4, 8])
@pytest.mark.parametrize("pre,n,post", MODEL_CASES)
def test_kernel_model_matches_float64(pre, n, post, kB):
    rng = np.random.default_rng(n * 7 + post)
    shape = (pre, n, post)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) \
        .astype(np.complex64).ravel()
    for inverse in (False, True):
        y, count = kernel_model(x, pre, n, post, inverse, kB)
        assert (count == 1).all()
        ref = (np.fft.ifft if inverse else np.fft.fft)(
            x.astype(np.complex128).reshape(shape), axis=1).ravel()
        fwd = float(np.abs(y - ref).max() / np.abs(ref).max())
        assert fwd <= 1e-5, f"forward rel err {fwd:.3e}"
        back, _ = kernel_model(y, pre, n, post, not inverse, kB)
        trip = float(np.abs(back - x).max() / np.abs(x).max())
        assert trip <= 1e-6, f"round trip rel err {trip:.3e}"
