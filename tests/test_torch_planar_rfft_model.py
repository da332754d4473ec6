"""A float32 numpy model of ``planar_rfft.cu``'s r2c (rows 8, 21, 4 and
17): its paired untangle in every output mode and its split of the rows
into tiles, runs and slots.

The CUDA kernel (``planar_rfft_kernel`` in
``mpifft4py_tpu_torch/ops/csrc/planar_rfft.cu``) runs only on the card.  Two
parts of it are arithmetic that a CPU can hold to account:

- **The paired untangle.**  A real row x of length n = 2h is transformed as
  the h-point FFT Z of z_t = x[2t] + i·x[2t+1]; one thread then takes the
  pair (k, h − k) of a row and computes X[k] and X[h − k] from one load
  each of Z[k] and Z[h − k] and one twiddle w = tw_n[k] = e^{−2πik/n}
  (``untangle_pair``: e^{−2πi(h−k)/n} = −conj(w)); k = h/2 is its own
  partner, k = 0 gives X[0] and, when nf = h + 1, X[h].  It folds in the
  scale, the doubled column nf − 1 and the zero columns nf..ld − 1.  The
  model repeats that arithmetic in float32, operation by operation, on
  numpy's spectrum of z rounded to complex64 (the stages themselves are
  modelled by tests/test_torch_prime_stage.py; here, at lengths whose h has
  a prime >= 11, the spectrum also comes from that model), counts the
  writes of each output column, and is held against numpy's float64
  ``rfft`` (1e-5 of max |X|, the kernel's tolerance on the card) at every
  even n in 4..2048, with nf = n/2 + 1 and with nf < n/2 + 1 into a width
  > nf.  The packed modes (rows 4 and 17, nf = ld = h) differ only in
  column 0, which carries the rider X[0] + i·X[h], and, in DIF order, in
  where column k goes: lane ``zdif_lane(k, n)`` (packed_z.cuh's closed
  form, repeated here).  They are held against numpy's float64 ``rfft`` in
  the packed layout at every even n in 16..2048 (natural order) and at n =
  512, 768, 1024 (DIF order, unpermuted with the port's ``zdif_iperm``),
  and at n = 256 and 512 against the JAX package's ``rfft_last_packed``
  and ``pallas_zdif.rfft_last_zdif`` (Pallas in interpret mode).
- **The tile split.**  ``rfft_tile`` picks RB rows a tile and SL floats a
  slot from (n, ld, the output's value width); ``bulkring::run_of`` splits
  each tile's input run (RB·n floats) and output runs (RB·ld values a
  plane) into an unaligned head, a bulk part and a tail.  The model walks
  every tile of a stack, the ragged last one included, for bases 0–3
  values off the 16-byte grid, and checks that every input and output
  value is covered exactly once, that every bulk run is 16-byte aligned
  and sized and lies inside its slot, and that an aligned tensor goes
  wholly by bulk copy.

Run on the CPU (seconds):

    python -m pytest tests/test_torch_planar_rfft_model.py -q
"""

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from mpifft4py_tpu.ops import pallas_fft3d as jp3
from mpifft4py_tpu.ops import pallas_zdif as jzd
from mpifft4py_tpu_torch.ops import zdif as tzd
from test_torch_packed import _one_torch_thread  # noqa: F401
from test_torch_prime_stage import make_plan, model_fft

F32 = np.float32
K_TILE = 4096            # fftblock::kTile
MAX_SMEM = 232448        # an H100 block's opt-in shared memory (bytes)
SM_SMEM = 233472         # an H100 multiprocessor's shared memory (bytes)
BLOCK_RESERVED = 1024    # bytes the runtime reserves a block


# -- the paired untangle ---------------------------------------------------

def spectrum(x):
    """Z of each row: the h-point FFT of z_t = x[2t] + i·x[2t+1], float32
    (the kernel's Stockham model where h has a prime factor >= 11, else
    numpy's float64 FFT rounded to complex64)."""
    z = x[:, 0::2].astype(F32) + 1j * x[:, 1::2].astype(F32)
    h = z.shape[1]
    if max(make_plan(h), default=1) >= 11:
        return model_fft(z.T.astype(np.complex64)).T
    return np.fft.fft(z.astype(np.complex128), axis=1).astype(np.complex64)


def zdif_lane(k, n):
    """packed_z.cuh's ``zdif_lane``: the lane of column k in DIF order."""
    r = n // 128
    b, t = k % r, k // r
    off = np.where(b == r // 2, 64,
                   128 * np.minimum(b, r - b) + np.where(b > r // 2, 64, 0))
    return off + t


def untangle_model(Z, n, nf, ld, dbl, scale, mode="planar"):
    """The kernel's untangle of Z (rows, h) into (rows, ld) columns, float32
    as the kernel computes it, and how often each column was written.
    ``mode``: "planar" (the planar and complex64 outputs), "packed" (the
    rider in column 0) or "dif" (packed, column k at lane zdif_lane(k))."""
    h = n // 2
    rows = Z.shape[0]
    ang = -2.0 * np.pi * np.arange(h) / n
    twr, twi = np.cos(ang).astype(F32), np.sin(ang).astype(F32)
    scale, last = F32(scale), F32(2 * scale if dbl else scale)
    yr = np.zeros((rows, ld), F32)
    yi = np.zeros((rows, ld), F32)
    writes = np.zeros(ld, int)

    def put(c, re, im):
        if mode == "dif":
            c = zdif_lane(np.asarray(c), n)
        yr[:, c], yi[:, c] = re, im
        np.add.at(writes, c, 1)

    Zr, Zi = Z.real.astype(F32), Z.imag.astype(F32)
    if mode == "planar":                                 # item k = 0
        put(0, (Zr[:, 0] + Zi[:, 0]) * scale, F32(0))
        if nf == h + 1:
            put(h, (Zr[:, 0] - Zi[:, 0]) * scale, F32(0))
    else:                                                # the rider
        put(0, (Zr[:, 0] + Zi[:, 0]) * scale, (Zr[:, 0] - Zi[:, 0]) * scale)
    k = np.arange(1, min(h // 2 + 1, nf))              # the other items
    zr, zi, fr, fi = Zr[:, k], Zi[:, k], Zr[:, h - k], Zi[:, h - k]
    half = F32(0.5)
    er, ei = half * (zr + fr), half * (zi - fi)
    o_r, o_i = half * (zi + fi), half * (fr - zr)
    a = twr[k] * o_r - twi[k] * o_i
    b = twr[k] * o_i + twi[k] * o_r
    wk = np.where(k == nf - 1, last, scale)
    put(k, (er + a) * wk, (ei + b) * wk)
    own = (h - k != k) & (h - k < nf)                  # X[h - k] kept
    kf = h - k[own]
    wf = np.where(kf == nf - 1, last, scale)
    put(kf, (er - a)[:, own] * wf, (b - ei)[:, own] * wf)
    put(np.arange(nf, ld), F32(0), F32(0))             # the zero columns
    return yr + 1j * yi, writes


def rfft_reference(x, nf, ld, dbl, scale):
    X = np.fft.rfft(x.astype(np.float64), axis=1)[:, :nf].copy()
    if dbl:
        X[:, -1] *= 2
    return np.pad(X * scale, ((0, 0), (0, ld - nf)))


def _configs(n):
    """(nf, ld, dbl, scale): the full spectrum (row 21), the full spectrum
    into a wider row with a scale, and a truncation to about n/3 + 1
    columns, doubled, into width nf + 3 (the 3/2 rule's z stage into the
    pencil's aligned width)."""
    h = n // 2
    cut = min(max(2, n // 3 + 1), h)
    return [(h + 1, h + 1, 0, 1.0), (h + 1, h + 4, 0, 0.75),
            (cut, cut + 3, 1, 1 / 1.5 ** 3)]


@pytest.mark.parametrize("n", range(4, 2049, 2))
def test_paired_untangle_matches_float64(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)).astype(F32)
    Z = spectrum(x)
    for nf, ld, dbl, scale in _configs(n):
        got, writes = untangle_model(Z, n, nf, ld, dbl, scale)
        assert (writes == 1).all(), (nf, ld, np.flatnonzero(writes != 1))
        ref = rfft_reference(x, nf, ld, dbl, scale)
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        assert err <= 1e-5, f"n={n} nf={nf} ld={ld}: rel err {err:.3e}"
        assert (got[:, nf:] == 0).all()


def packed_reference(x):
    """numpy's float64 rfft in the packed layout: h columns, column 0
    X[0] + i·X[h]."""
    h = x.shape[1] // 2
    X = np.fft.rfft(x.astype(np.float64), axis=1)
    P = X[:, :h].copy()
    P[:, 0] = X[:, 0].real + 1j * X[:, h].real
    return P


def packed_model(x, dif=False):
    """The packed r2c of the kernel (nf = ld = h, scale 1), its output in
    lane order, with each lane's write count."""
    n = x.shape[1]
    return untangle_model(spectrum(x), n, n // 2, n // 2, 0, 1.0,
                          "dif" if dif else "packed")


@pytest.mark.parametrize("dif,n", [(False, n) for n in range(16, 2049, 2)]
                         + [(True, n) for n in (512, 768, 1024)])
def test_packed_untangle_matches_float64(dif, n):
    rng = np.random.default_rng(n + dif)
    x = rng.standard_normal((3, n)).astype(F32)
    got, writes = packed_model(x, dif)
    assert (writes == 1).all(), np.flatnonzero(writes != 1)
    if dif:
        got = got[:, tzd.zdif_iperm(n)]
    ref = packed_reference(x)
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    assert err <= 1e-5, f"n={n} dif={dif}: rel err {err:.3e}"


@pytest.mark.parametrize("n,dif", [(256, False), (512, True)])
def test_packed_model_matches_pallas(n, dif):
    """The model (rows 4 and 17) against the JAX package's Pallas kernels
    in interpret mode on 8 seeded rows, 1e-5 of max |reference|; the
    model's lane map is the reference's DIF order."""
    x = np.random.default_rng(7).standard_normal((8, n)).astype(F32)
    got, _ = packed_model(x, dif)
    with pltpu.force_tpu_interpret_mode():
        fn = jzd.rfft_last_zdif if dif else jp3.rfft_last_packed
        yr, yi = (np.asarray(a) for a in fn(jnp.asarray(x)))
    ref = yr + 1j * yi
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    assert err <= 1e-5, f"n={n} dif={dif}: rel err {err:.3e}"
    if dif:
        h = n // 2
        np.testing.assert_array_equal(zdif_lane(np.arange(h), n),
                                      np.asarray(jzd.zdif_iperm(n)))


# -- the tile split ---------------------------------------------------------

def slot_plane(L):
    """``bulkring::slot_plane``: floats a plane of a slot."""
    return (L + 7) & ~3


def rfft_tile(n, ld, kB, max_smem=MAX_SMEM):
    """``rfft_tile`` of planar_rfft.cu: (RB, SL, smem), RB = 0 if none."""
    h = n // 2
    best = (0, 0, 0)
    for RB in range(K_TILE // h, 0, -1):
        out = RB * ld
        if 8 * out > max_smem:
            continue
        SL = max(slot_plane(RB * n), 2 * slot_plane(out))
        smem = 4 * 2 * SL + 8 * h * (RB + 1) + 16
        if smem > max_smem:
            continue
        if (RB * n * 4) % 16 == 0 and (out * kB) % 16 == 0:
            return RB, SL, smem
        if not best[0]:
            best = (RB, SL, smem)
    return best


def run_of(addr, kB, length):
    """``bulkring::run_of`` of a run of `length` values of kB bytes that
    starts at byte address addr: (mis, head, bulk)."""
    unit = 16 // kB
    mis = (addr & 15) // kB
    head = min((unit - mis) % unit, length)
    bulk = (length - head) // unit * unit
    return mis, head, bulk


def walk(rows, n, ld, kB, base_in, base_out):
    """Every tile of a stack: each value's coverage count (input floats,
    output values of each plane) and the bulk runs as (address, bytes,
    first slot float, last slot float + 1)."""
    RB, SL, _ = rfft_tile(n, ld, kB)
    assert RB >= 1
    PL = slot_plane(ld * RB)
    cov_in = np.zeros(rows * n, int)
    cov_out = [np.zeros(rows * ld, int) for _ in base_out]
    bulks = []
    for tile in range(-(-rows // RB)):
        nrows = min(RB, rows - tile * RB)
        v0, length = tile * RB * n, nrows * n
        mis, head, bulk = run_of(base_in + 4 * v0, 4, length)
        cov_in[v0:v0 + length] += 1            # bulk, head and tail
        bulks.append((base_in + 4 * (v0 + head), 4 * bulk, mis + head,
                      mis + head + bulk))
        # the landing pass reads the pair (f, f + 1) from the slot or, off
        # the bulk part, from global memory
        for f in range(0, length, 2):
            both = head <= f and f + 1 < head + bulk
            assert both or not (mis % 2 == 0 and head <= f < head + bulk)
        w0, lout = tile * RB * ld, nrows * ld
        for p in range(len(base_out)):
            mis, head, bulk = run_of(base_out[p] + kB * w0, kB, lout)
            cov_out[p][w0:w0 + lout] += 1
            off = p * PL + (mis + head) * kB // 4
            bulks.append((base_out[p] + kB * (w0 + head), kB * bulk, off,
                          off + bulk * kB // 4))
    return cov_in, cov_out, bulks


# (n, ld, kB): rows 21 and 8, the pencil's z stage into widths 130 and 132,
# the envelope's ends, an h with a prime stage and widths far above nf;
# the packed rows (ld = h): row 4, the packed envelope's ends, row 17
TILE_CASES = [(256, 129, 8), (384, 129, 4), (256, 130, 4), (256, 132, 4),
              (2048, 1025, 8), (2048, 1025, 4), (2042, 1022, 4), (4, 3, 8),
              (4, 300, 4), (6, 4, 4), (16, 9, 8), (130, 66, 4),
              (1000, 5000, 4), (768, 385, 8), (256, 128, 4), (16, 8, 4),
              (1024, 512, 4), (2042, 1021, 4)]


@pytest.mark.parametrize("mis", [0, 1, 2, 3])
@pytest.mark.parametrize("n,ld,kB", TILE_CASES)
def test_tile_split_covers_every_value_once(n, ld, kB, mis):
    RB, SL, smem = rfft_tile(n, ld, kB)
    assert 1 <= RB and (n // 2) * RB <= K_TILE and smem <= MAX_SMEM
    assert SL % 4 == 0 and SL >= slot_plane(RB * n)
    assert SL >= 2 * slot_plane(RB * ld)
    planes = 1 if kB == 8 else 2
    # a base `mis` values off the grid (complex64: its float2 values, so
    # mis 2 and 3 fall back on the grid or one value off it), the planar
    # im plane off by one more; stacks of one tile, whole tiles and ragged
    out_base = [kB * (mis % (16 // kB)), 4 * ((mis + 1) % 4)][:planes]
    for rows in (1, RB, 3 * RB + 1, 201):
        cov_in, cov_out, bulks = walk(rows, n, ld, kB, 4 * mis, out_base)
        assert (cov_in == 1).all()
        assert all((c == 1).all() for c in cov_out)
        for addr, size, lo, hi in bulks:
            assert addr % 16 == 0 and size % 16 == 0
            assert lo % 4 == 0 and 0 <= lo <= hi <= SL


@pytest.mark.parametrize("n,ld,kB", TILE_CASES)
def test_aligned_tiles_go_wholly_by_bulk_copy(n, ld, kB):
    """A tensor whose base is 16-byte aligned: every tile but a ragged last
    one is one bulk run in and one a plane out (every case here finds an
    aligned RB, the widest ones by fewer rows)."""
    RB, SL, _ = rfft_tile(n, ld, kB)
    assert (RB * n * 4) % 16 == 0 and (RB * ld * kB) % 16 == 0
    for tile in range(4):
        v0 = tile * RB * n
        assert run_of(4 * v0, 4, RB * n) == (0, 0, RB * n)
        w0 = tile * RB * ld
        assert run_of(kB * w0, kB, RB * ld) == (0, 0, RB * ld)


def test_main_path_tiles():
    """Rows 21 and 8, the pencil's z stage, rows 4 and 17: RB = 32, 20, 32,
    32 and 8 rows a tile (the most with h·RB <= kTile and aligned runs; row
    8's planar ld = 129 needs a multiple of 4), two blocks a
    multiprocessor."""
    for n, ld, kB, RB_want in ((256, 129, 8, 32), (384, 129, 4, 20),
                               (256, 130, 4, 32), (256, 128, 4, 32),
                               (1024, 512, 4, 8)):
        RB, SL, smem = rfft_tile(n, ld, kB)
        assert RB == RB_want
        assert (RB * n * 4) % 16 == 0 and (RB * ld * kB) % 16 == 0
        assert 2 * (smem + BLOCK_RESERVED) <= SM_SMEM
