"""A float32 numpy model of ``fft_axis.cu`` (rows 1 and 19): its choice
between the register passes and the shared-memory stages, its tile width,
threads and shared memory, its persistent walk over column tiles, its
copies of each row segment, and the register passes in the kernel's thread
order.

The CUDA kernels (``fft_axis_kernel_passes`` and ``fft_axis_kernel``, the
stages, in ``mpifft4py_tpu_torch/ops/csrc/fft_axis.cu``) run only on the
card.  The parts of them that are index arithmetic a CPU can hold to
account:

- **The plan.**  ``pass_plan`` splits n into one or two radices of
  ``kRadix`` (2^a 3^b up to 32, b <= 1): the most even split, the larger
  radix first.  The launch takes the register passes where there is a
  split and the rows lie on the 16-byte grid, or the values are complex64;
  else ``fft_axis_kernel``, the stages of ``fft_block.cuh``: planar rows
  off the grid, and the plans with a factor 3^3 or a prime above 3.  The
  stages' plain instance (radix 2/3/4) serves planar plans, the mixed one
  (also radix 5/7 and pair sums) the rest and every complex64 plan.
- **The tile width.**  ``tile_cols`` picks T, a power of two, from (n,
  pre, post, the value's bytes): the most columns with n·T <= kAxisTile,
  widened (n·T <= kAxisMaxTile) to a 32-byte sector a row segment, or 64
  bytes where the rows start off the grid, at most ``post`` rounded up to
  a power of two (but a 16-byte unit), then fewer, down to that width,
  while the tiles would not give every multiprocessor two.  The register
  passes then halve T while their two slots (rows of P = T values, T + U
  off the grid) and their work tile would pass a block's shared memory.
  The model checks the launch (threads, shared memory, blocks a
  multiprocessor) over the envelope and at the cells' shapes.
- **The walk and the copies.**  Tile t of the persistent grid is (p, q0) =
  divmod(t, ceil(post/T)) with w = min(T, post − q0) columns; a plane's
  row segment r starts at value g0 + r·post.  The register passes' loads
  cut each row of the slot into 16-byte chunks: a chunk that lies inside
  the segment goes by one 16-byte cp.async, the values of a chunk that
  holds the segment's head or tail one by one; the segment lands m(r)
  values into its row, its offset past the 16-byte grid (0 where every
  segment starts on it: the aligned instance).  The model walks every tile
  for bases 0–3 values off the grid, in both layouts, and checks that every
  input value is copied exactly once, to where the kernel reads it, with
  every 16-byte copy aligned on both sides and inside its plane; that every
  output value is stored exactly once; that an aligned tensor goes wholly
  in 16-byte copies; at row 19 (complex64 (256, 256, 129), 1032-byte rows
  off the grid) that each segment's interior goes in 16-byte copies and
  only its head and tail value by value; and that the 3/2 rule's y stage
  (3, 768, 768, 257), whose 1028-byte planar rows start off the grid,
  takes the stages.  The stages kernel keeps its own copies (16-byte
  chunks where a tile lies on the grid, else value by value).
- **The register passes.**  The first pass takes sub-transform (j, c) of
  column c (rows j + t·S, S = n/r1), conjugated for the inverse, and
  leaves its r1 outputs at work rows j·(r1 + 1) + t; the second takes
  (k, c) from work rows k + t·(r1 + 1), times tw[t·k] (conjugated for the
  inverse), and stores output k + t·r1 of column c, times the scale (the
  conjugation and 1/n for the inverse).  The model runs both passes in the
  kernel's thread order in float32 over whole tiles and holds the result
  against numpy's float64 FFT (1e-5 of max |X|) and in a round trip (1e-6
  of max |x|), the kernel's tolerances on the card.  The stages' plans
  (radix 5/7, pair sums) keep their model: the plan's other stages by
  tests/test_torch_prime_stage.py's float32 model, then the last stage in
  the kernel's thread order (``last_stage_cols``).

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
K_WIDE = 64              # fft_axis.cu kWide: bytes a segment (the passes;
                         # the stages off the grid)
K_RADIX = (2, 3, 4, 6, 8, 12, 16, 24, 32)   # fft_axis.cu kRadix
K_AXIS_SLOTS = 2         # fft_axis.cu kAxisSlots
K_AXIS_THREADS = 512     # fft_axis.cu kAxisThreads
SMS = 132                # an H100 SXM's multiprocessors
MAX_SMEM = 232448        # an H100 block's opt-in shared memory (bytes)
SM_SMEM = 233472         # an H100 multiprocessor's shared memory (bytes)
BLOCK_RESERVED = 1024    # bytes the runtime reserves a block


def mixed(n):
    """``fftblock::mixed_plan``: a radix above 4."""
    return max(make_plan(n)) > 4


def pass_plan(n):
    """``pass_plan`` of fft_axis.cu: (r1, r2) with n = r1·r2 over K_RADIX
    (r2 = 1: one pass), or (0, 0)."""
    if n in K_RADIX:
        return n, 1
    best = (0, 0)
    for a in K_RADIX:
        if n % a or n // a not in K_RADIX:
            continue
        lo = min(a, n // a)
        if not best[0] or lo > min(best) or (lo == min(best) and a > best[0]):
            best = (a, n // a)
    return best


def tile_cols(n, pre, post, kB, seg, sms=SMS):
    """``tile_cols`` of fft_axis.cu: T, the columns a tile, for segments
    of seg bytes at least."""
    unit = 16 // kB
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


def stages_seg(post, kB):
    """The stages' segment bytes: a 32-byte sector, K_WIDE where the rows
    start off the grid."""
    return K_WIDE if (post * kB) % 16 else 32


def on_grid(post, kB, bases):
    """The aligned instance: the row pitch and every input plane's base on
    the 16-byte grid (the outputs are stored value by value)."""
    return (post * kB) % 16 == 0 and all(b % 16 == 0 for b in bases)


def pass_smem(n, T, P, r1, r2):
    """``pass_smem``: the slots, the work tile (two passes), the
    mbarriers."""
    work = 8 * (n + n // r1) * T if r2 > 1 else 0
    return 4 * K_AXIS_SLOTS * 2 * n * P + work + 8 * K_AXIS_SLOTS


def stages_mixed(n, kB):
    """The stages' mixed instance: a radix above 4, or complex64."""
    return mixed(n) or kB == 8


def launch(n, pre, post, kB, grid=None):
    """(kernel, T, P, threads, shared memory bytes, tiles) of the launch:
    ``launch_passes`` where n has a pass plan and the rows lie on the grid
    or the values are complex64, else ``launch_instance`` (the stages).
    grid: the aligned instance (default: the pitch on the grid)."""
    if grid is None:
        grid = (post * kB) % 16 == 0
    r1, r2 = pass_plan(n)
    passes = r1 and (grid or kB == 8)
    T = tile_cols(n, pre, post, kB,
                  K_WIDE if passes else stages_seg(post, kB))
    if not passes:
        kE = 8 if stages_mixed(n, kB) else 16
        threads = -(-n * T // (kE * 32)) * 32
        smem = 4 * 4 * n * T + 8 * n * T + 16
        return "stages", T, T, threads, smem, pre * -(-post // T)
    U = 16 // kB

    def pitch(T):
        return T if grid else T + U
    while T > U and pass_smem(n, T, pitch(T), r1, r2) > MAX_SMEM:
        T //= 2
    subs = T if r2 == 1 else max(r1, r2) * T
    threads = min(K_AXIS_THREADS, -(-subs // 32) * 32)
    P = pitch(T)
    return ("passes", T, P, threads, pass_smem(n, T, P, r1, r2),
            pre * -(-post // T))


def blocks_per_sm(smem):
    return SM_SMEM // (smem + BLOCK_RESERVED)


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
    """``whole_chunks`` (the stages kernel): the plane's tile goes in
    16-byte chunks (every segment on the grid, w values a multiple of 16
    bytes)."""
    return (post * kB) % 16 == 0 and (w * kB) % 16 == 0 and \
        (base + g0 * kB) % 16 == 0


def walk(pre, n, post, kB, bases, T):
    """The stages kernel's ``load_cols``/``store_cols`` over every tile of
    a stack: each plane's coverage of its (pre, n, post) values, the 16-byte
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


def load_copies(pre, n, post, kB, base, T, P, grid):
    """The register passes' ``load_plane`` for one plane over every tile:
    (coverage of its values, 16-byte copies, single-value copies), each
    copy a (global byte address, slot byte offset, segment value c) row;
    the plane's slot starts at byte 0.  Segment r of a tile lands m(r)
    values into slot row r (P values), its chunks q = 0..P/U−1."""
    U = 16 // kB
    C = P // U
    g0, w = tiles_of(pre, n, post, T)
    seg = g0[:, None, None] + np.arange(n)[None, :, None] * post
    m = 0 if grid else (base // kB + seg) % U
    lo = np.broadcast_to(np.arange(C)[None, None, :] * U - m,
                         (len(g0), n, C))            # (tiles, n, C)
    rr = np.broadcast_to(np.arange(n)[None, :, None], lo.shape)
    qq = np.broadcast_to(np.arange(C)[None, None, :], lo.shape)
    seg = np.broadcast_to(seg, lo.shape)
    wt = w[:, None, None]
    size = pre * n * post
    inside = (lo >= 0) & (lo + U <= wt)
    c, g = lo[inside], seg[inside] + lo[inside]
    whole = np.stack([base + g * kB,
                      (rr[inside] * P + qq[inside] * U) * kB, c], -1)
    cov = np.bincount((g[:, None] + np.arange(U)).ravel(), minlength=size)
    single = [np.zeros((0, 3), int)]
    for e in range(U if not grid else 0):
        ce = lo + e
        ok = ~inside & (ce >= 0) & (ce < wt)
        c, g = ce[ok], seg[ok] + ce[ok]
        single.append(np.stack(
            [base + g * kB, (rr[ok] * P + qq[ok] * U + e) * kB, c], -1))
        cov = cov + np.bincount(g, minlength=size)
    return cov, whole, np.concatenate(single)


def store_coverage(pre, n, post, T):
    """The second (or only) pass's stores over every tile: output (k + t·r1,
    c) of each live column once; the write count of every output value."""
    r1, r2 = pass_plan(n)
    Ns, R = (r1, r2) if r2 > 1 else (1, r1)
    rows = (np.arange(Ns)[:, None] + np.arange(R)[None, :] * Ns).ravel()
    g0, w = tiles_of(pre, n, post, T)
    c = np.arange(T)
    live = c[None, :] < w[:, None]                       # (tiles, T)
    g = g0[:, None, None] + rows[None, :, None] * post + c[None, None, :]
    return np.bincount(g[np.broadcast_to(live[:, None, :], g.shape)],
                       minlength=pre * n * post)


def _check_passes_walk(pre, n, post, kB, bases, launched=None):
    """The register passes' copies of each plane (planar: re and im, each
    its own base): every value once, each to slot row r at m(r) + c, 16-byte
    copies aligned and inside the plane; every output once.  The tiles of
    the launch at pre = ``launched`` (default ``pre``), walked over the
    first ``pre``.  Returns (T, the 16-byte copies, the single copies)."""
    grid = on_grid(post, kB, bases)
    _, T, P, _, _, _ = launch(n, launched or pre, post, kB, grid)
    U = 16 // kB
    assert (T * kB) % 16 == 0 and T & (T - 1) == 0 and P % U == 0
    plane = n * P * kB
    wholes, singles = [], []
    for base in bases:
        cov, whole, single = load_copies(pre, n, post, kB, base, T, P, grid)
        assert (cov == 1).all()
        for copies, size in ((whole, 16), (single, kB)):
            addr, off, c = copies[:, 0], copies[:, 1], copies[:, 2]
            assert (addr % size == 0).all() and (off % size == 0).all()
            assert (off >= 0).all() and (off + size <= plane).all()
            # where TileIn::at reads value c of row r: r·P + m(r) + c
            row = off // kB // P
            m = 0 if grid else (addr // kB - c) % U
            assert (off // kB == row * P + m + c).all()
        wholes.append(whole)
        singles.append(single)
    assert (store_coverage(pre, n, post, T) == 1).all()
    return T, wholes, singles


def _check_walk(pre, n, post, kB, bases):
    kind, T, _, _, _, _ = launch(n, pre, post, kB, on_grid(post, kB, bases))
    if kind == "passes":
        T, wholes, singles = _check_passes_walk(pre, n, post, kB, bases)
        return T, wholes, np.array([len(s) > 0 for s in singles])
    assert (T * kB) % 16 == 0 and T & (T - 1) == 0
    cov, whole, single, singly = walk(pre, n, post, kB, bases, T)
    assert all((cv == 1).all() for cv in cov)
    for copies, size in ((whole, 16), (single, kB)):
        addr, off = copies[:, 0], copies[:, 1]
        assert (addr % size == 0).all() and (off % size == 0).all()
        assert (off >= 0).all() and (off + size <= 2 * 4 * n * T).all()
    return T, whole, singly


# (pre, n, post, kB): the main path's stages cut in depth (row 1's x stage
# with fewer columns, the y stage, the 3/2 rule's n = 384, row 19's y
# stage, NS2D's x stage), small posts (1, 5, 129, 130), the stages' plans
# (a prime stage at 1016, radix 5 at 640, 3^3 at 27), the smallest n, one
# pass (12, 32) and a radix 3 first pass (9)
WALK_CASES = [(1, 256, 4096, 4), (16, 256, 128, 4), (4, 384, 384, 4),
              (8, 256, 129, 8), (1, 1024, 512, 4), (3, 256, 1, 4),
              (3, 256, 5, 8), (2, 256, 129, 4), (2, 256, 130, 4),
              (2, 256, 130, 8), (3, 1016, 5, 4), (1, 2, 129, 8),
              (2, 640, 20, 4), (3, 40, 33, 8), (2, 768, 257, 4),
              (3, 512, 36, 4), (2, 27, 7, 4), (3, 12, 133, 4),
              (2, 32, 66, 8), (4, 9, 21, 4)]


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
                                           (2, 256, 132, 4),
                                           (4, 512, 256, 4),
                                           (2, 768, 260, 4)])
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
    every other segment starts 8 bytes off the grid.  The register passes'
    off-grid instance copies each segment's interior in 16-byte chunks and
    only a value at its head or tail singly; each pre's last tile has one
    column and transforms only it."""
    pre, n, post = 256, 256, 129
    kind, T, P, _, _, _ = launch(n, pre, post, 8)
    assert (kind, T, P) == ("passes", 16, 18) and -(-post // T) == 9
    g0, w = tiles_of(pre, n, post, T)
    assert sorted(set(w.tolist())) == [1, 16] and (w == 1).sum() == pre
    T, wholes, singles = _check_passes_walk(2, n, post, 8, [0], pre)
    # a 16-value segment: 8 chunks on the grid, or 7 and a value at each end
    assert len(wholes[0]) == 2 * 8 * (n * 8 - n // 2)
    assert len(singles[0]) == 2 * (8 * n + n)


def test_padded_y_rows_off_the_grid():
    """The 3/2 rule's y stage, (3, 768, 768, 257) along axis 2 (the padded
    cell): 1028-byte rows, so segment r starts r mod 4 values off the grid.
    The launch takes the stages' plain instance (the register passes' copies
    of such segments were the slower on the card), 8 columns, 384 threads,
    one block a multiprocessor, every value copied singly and once; the last
    tile of each row has one column.  The walk repeats with period 4 in p
    (p·n·post mod 4 = 0 here, so every p alike): pre = 2 covers it."""
    pre, n, post = 3 * 768, 768, 257
    kind, T, P, threads, smem, tiles = launch(n, pre, post, 4)
    assert (kind, T, P, threads) == ("stages", 8, 8, 384)
    assert not stages_mixed(n, 4)
    assert smem <= MAX_SMEM and blocks_per_sm(smem) == 1
    assert tiles == pre * 33
    _, w = tiles_of(2, n, post, T)
    assert (w == 1).sum() == 2 and (w == 8).sum() == 2 * 32
    T2, whole, singly = _check_walk(2, n, post, 4, [0, 0])
    assert T2 == T and len(whole) == 0 and singly.all()


def test_main_path_tiles():
    """Kernel, T, P, threads and blocks a multiprocessor at the cells'
    shapes and the main path's others: the register passes at n = 512 (the
    packed and MHD y stages, the round trip) 16 columns (64-byte
    segments), 512 threads, one block; at n = 768 (the padded cell's x
    stage) and n = 1024 (slab_p4's rank blocks) 8 columns, 256 threads, one
    block; the padded cell's y stage (rows off the grid) the stages, 8
    columns, 384 threads; n = 256 and row 19 16 columns, two blocks; the
    widened plans 640 and 1016 the stages."""
    for (pre, n, post, kB), want in (
            ((1536, 512, 256, 4), ("passes", 16, 16, 512, 1)),
            ((3072, 512, 256, 4), ("passes", 16, 16, 512, 1)),
            ((1, 512, 131072, 4), ("passes", 16, 16, 512, 1)),
            ((512, 512, 256, 4), ("passes", 16, 16, 512, 1)),
            ((2304, 768, 257, 4), ("stages", 8, 8, 384, 1)),
            ((3, 768, 131584, 4), ("passes", 8, 8, 256, 1)),
            ((768, 1024, 512, 4), ("passes", 8, 8, 256, 1)),
            ((3, 1024, 131072, 4), ("passes", 8, 8, 256, 1)),
            ((1, 256, 32768, 4), ("passes", 16, 16, 256, 2)),
            ((256, 256, 129, 8), ("passes", 16, 18, 256, 2)),
            ((384, 384, 384, 4), ("passes", 16, 16, 384, 1)),
            ((1, 1024, 512, 4), ("passes", 8, 8, 256, 1)),
            ((1, 640, 32768, 4), ("stages", 8, 8, 640, 1)),
            ((1, 1016, 32768, 4), ("stages", 8, 8, 1024, 1))):
        kind, T, P, threads, smem, _ = launch(n, pre, post, kB)
        assert smem <= MAX_SMEM
        got = (kind, T, P, threads, min(blocks_per_sm(smem), 2))
        assert got == want, (pre, n, post, kB, got)


@pytest.mark.parametrize("kB", [4, 8])
def test_launch_fits_over_the_envelope(kB):
    """Every n the wrappers take (planar: ``supported_c2c``; complex64:
    2..1024), with posts from 1 to 32768, pre 1, 3, 256, both instances:
    the threads a whole number of warps within the kernel's launch bounds,
    shared memory within a block's, a segment of 64 bytes (the stages': a
    32-byte sector where rows start on the grid) unless ``post`` is
    narrower or the tile or shared memory would pass its limit, rows of
    whole 16-byte chunks; the stages hold the tile's values in their
    threads."""
    ns = range(2, 1025) if kB == 8 else [n for n in range(2, 1025)
                                         if supported_c2c(n)]
    for n in ns:
        for pre in (1, 3, 256):
            for post in (1, 3, 5, 129, 130, 4096, 32768):
                for grid in ({False, (post * kB) % 16 == 0}):
                    kind, T, P, threads, smem, _ = launch(n, pre, post, kB,
                                                          grid)
                    assert n * T <= K_AXIS_MAX_TILE
                    assert smem <= MAX_SMEM and threads % 32 == 0
                    assert (P * kB) % 16 == 0 and T & (T - 1) == 0
                    seg = K_WIDE if kind == "passes" else \
                        stages_seg(post, kB)
                    full = tile_cols(n, pre, post, kB, seg)
                    assert (T * kB >= seg or T >= post or
                            2 * T * n > K_AXIS_MAX_TILE or T < full), \
                        (n, pre, post, T)
                    if kind == "stages":
                        kE = 8 if stages_mixed(n, kB) else 16
                        assert threads * kE >= n * T
                        assert threads <= K_AXIS_MAX_TILE // kE
                    else:
                        assert 32 <= threads <= K_AXIS_THREADS


def test_pass_plan_over_the_envelope():
    """Every 2^a 3^b <= 1024 with b <= 2 has a plan of one or two radices
    (the register passes); 3^3 and the primes above 3 take the stages."""
    for n in range(2, 1025):
        r1, r2 = pass_plan(n)
        m = n
        while m % 2 == 0:
            m //= 2
        b = 0
        while m % 3 == 0:
            m //= 3
            b += 1
        if m == 1 and b <= 2:
            assert r1 * r2 == n and r1 in K_RADIX
            assert r2 == 1 or (r2 in K_RADIX and n not in K_RADIX)
        else:
            assert (r1, r2) == (0, 0)
    assert [pass_plan(n) for n in (512, 768, 1024, 256, 384, 64, 9)] == [
        (32, 16), (32, 24), (32, 32), (16, 16), (24, 16), (8, 8), (3, 3)]


# -- the kernel end to end: copies, passes or stages, stores -----------------

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


def rdft(v):
    """The forward R-point DFT of the columns of v (R, m) in float32."""
    R = v.shape[0]
    ang = -2.0 * np.pi * np.outer(np.arange(R), np.arange(R)) / R
    return (np.exp(1j * ang).astype(np.complex64) @ v).astype(np.complex64)


def passes_tile(x, n, T, w, inverse):
    """The register passes on one tile x (n, T) complex64, in the kernel's
    thread order; returns the outputs (n, T) (NaN in dead columns) and their
    write counts."""
    r1, r2 = pass_plan(n)
    cj = F32(-1 if inverse else 1)
    scale = F32(1.0 / n if inverse else 1.0)
    twr, twi = twiddles(n, 1 if inverse else -1)
    fwd = (twr + 1j * twi * cj).astype(np.complex64)   # the forward table
    x = (x.real + 1j * x.imag * cj).astype(np.complex64)
    out = np.full((n, T), np.nan, np.complex64)
    writes = np.zeros((n, T), int)
    if r2 == 1:                              # pass_one: a thread a column
        c = np.arange(w)
        y = rdft(x[:, c])
        out[:, c] = y
        writes[:, c] += 1
    else:
        S, Ns = n // r1, r1
        work = np.full((n + S, T), np.nan, np.complex64)
        b = np.arange(S * T)                 # pass_first, c fastest
        j, c = b >> (T.bit_length() - 1), b & (T - 1)
        live = c < w
        j, c = j[live], c[live]
        t = np.arange(r1)[:, None]
        y = rdft(x[j[None, :] + t * S, c[None, :]])
        work[j[None, :] * (r1 + 1) + t, c[None, :]] = y
        b = np.arange(Ns * T)                # pass_last, c fastest
        k, c = b >> (T.bit_length() - 1), b & (T - 1)
        live = c < w
        k, c = k[live], c[live]
        t = np.arange(r2)[:, None]
        v = work[k[None, :] + t * (Ns + 1), c[None, :]]
        assert not np.isnan(v).any()
        v = (v * fwd[t * k[None, :]]).astype(np.complex64)
        y = rdft(v)
        rows = k[None, :] + t * Ns
        out[rows, c[None, :]] = y
        np.add.at(writes, (rows, np.broadcast_to(c[None, :], rows.shape)), 1)
    out = (out.real * scale + 1j * (out.imag * scale * cj)).astype(
        np.complex64)
    return out, writes


def stages_tile(x, n, T, w, inverse):
    """The stages kernel on one tile: all but the last stage by the float32
    model, the last stage in the kernel's order (or, after a pair-sum
    stage, the pass over the tile)."""
    sign = 1 if inverse else -1
    scale = 1.0 / n if inverse else 1.0
    plan = make_plan(n)
    fused = plan[-1] <= (7 if mixed(n) else 4)
    twr, twi = twiddles(n, sign)
    cols = x[:, :w]
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
        writes = last_stage_cols(work, n, w, T, plan[-1], sign, scale, out)
    else:                 # put(e mod T, e / T, s[e]) for columns < w
        e = np.arange(n * T)
        e = e[(e & (T - 1)) < w]
        k, c = e >> (T.bit_length() - 1), e & (T - 1)
        out[k * T + c] = work[e] * F32(scale)
        writes = np.zeros(n * T, int)
        np.add.at(writes, k * T + c, 1)
    return out.reshape(n, T), writes.reshape(n, T)


def kernel_model(x, pre, n, post, inverse, kB):
    """The kernel on complex (pre·n·post,) values x: every tile loaded
    into a slot of T columns (the walk checks how), transformed by the
    register passes or the stages, stored back.  Returns the output and
    each output value's write count."""
    kind, T, _, _, _, _ = launch(n, pre, post, kB)
    tile = passes_tile if kind == "passes" else stages_tile
    y = np.full(x.shape, np.nan, np.complex64)
    count = np.zeros(x.shape, int)
    r = np.arange(n)
    for g0, w in zip(*tiles_of(pre, n, post, T)):
        w = int(w)
        g = g0 + r * post
        slot = np.zeros((n, T), np.complex64)
        slot[:, :w] = x[(g[:, None] + np.arange(w)[None, :])]
        out, writes = tile(slot, n, T, w, inverse)
        assert (writes[:, :w] == 1).all() and (writes[:, w:] == 0).all()
        dst = (g[:, None] + np.arange(w)[None, :]).ravel()
        y[dst] = out[:, :w].ravel()
        np.add.at(count, dst, 1)
    return y, count


# (pre, n, post): register passes (256 = 16·16, 384 = 24·16, 512 = 32·16,
# 768 = 32·24, 1024 = 32·32, 9 = 3·3, 96 = 12·8) and one pass (16, 8, 32,
# 12, 6); the stages: radix 5 (640, 40), radix 7 (112, 28), 3^3 (27), the
# pair-sum stage last (129 = 3·43, 121 = 11², 1016 = 8·127, 11 alone)
MODEL_CASES = [(1, 256, 5), (3, 16, 129), (2, 8, 130), (1, 32, 1),
               (2, 384, 5), (3, 12, 33), (1, 640, 3), (2, 40, 129),
               (1, 112, 20), (3, 28, 5), (2, 129, 5), (1, 121, 3),
               (1, 1016, 2), (3, 11, 130), (1, 512, 9), (1, 768, 5),
               (1, 1024, 3), (2, 9, 21), (2, 96, 17), (3, 6, 7),
               (1, 27, 5)]


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
