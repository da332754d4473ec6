"""A float32 numpy model of ``curl_ifft_x.cu`` (row 11): its choice of tile
width from n, its persistent walk over the column tiles of the three
components, its split of each plane's tile into 16-byte or single-value
copies, the curl it forms from a slot and the column-fastest last stage
that stores straight to global memory.

The CUDA kernel (``curl_ifft_x_kernel`` in
``mpifft4py_tpu_torch/ops/csrc/curl_ifft_x.cu``) runs only on the card.  The
parts of it a CPU can hold to account:

- **The geometry.**  ``curl_cols`` picks T, a power of two, from n alone:
  the most with n·T <= kCurlTile, at most kCurlMaxCols; the block has
  kCurlGroup·n·T / kRowEPT threads in whole warps, and shared memory holds
  the slot's six planes and the work tile of kCurlGroup components.  The
  model repeats it and checks the launch over every ``curl_fused_ok`` n and
  at the main path's lengths.
- **The walk and the copies.**  Tile t covers columns q0 = t·T, w =
  min(T, Q − q0); each of the six planes (re, then im, of each component)
  goes to the slot as n row segments Q values apart, in 16-byte chunks
  where every segment starts on the 16-byte grid and spans whole chunks,
  else value by value.  The model walks every tile for bases 0–3 values
  off the grid and checks that every input value lands exactly once, that
  every 16-byte copy is aligned on both sides and inside the slot, and
  that every output value (component, row, column) is stored exactly once
  by the last stage's writes, group by group.
- **The curl from the slot.**  The kernel runs the tile's output
  components (the curl's three, then with the state the state's three) in
  groups of kCurlGroup: it forms each curl component, i K × Û (÷ |K|² with
  ``biot_savart``), from the slot's values of a (row, column) and the 1-D
  k vectors, or copies the state's, into the work tile's column gc·j + g,
  and transforms the gc·w columns with the Stockham plan
  (tests/test_torch_prime_stage.py's float32 stages; the last stage in the
  kernel's order, tests/test_torch_fft_axis_model.py's
  ``last_stage_cols``, or after a pair-sum stage the pass over the tile).
  The curl before the transform is held to float64 at 1e-6 of its max, the
  stored result to ``curl_ifft_x_ref`` in float64 at 1e-5 of its max (the
  kernel's tolerance on the card), with and without ``biot_savart`` and the
  state.

Run on the CPU (seconds):

    python -m pytest tests/test_torch_curl_ifft_x_model.py -q
"""

import numpy as np
import pytest
import torch

from mpifft4py_tpu_torch.ops import fft3d as p3
from test_torch_fft_axis_model import last_stage_cols
from test_torch_packed import _one_torch_thread  # noqa: F401
from test_torch_prime_stage import make_plan, pairsum_stage, \
    register_stage, twiddles

F32 = np.float32
K_CURL_TILE = 4096       # curl_ifft_x.cu kCurlTile: n·T at most
K_CURL_MAX_COLS = 16     # kCurlMaxCols
K_CURL_GROUP = 2         # kCurlGroup: components a transform
MAX_SMEM = 232448        # an H100 block's opt-in shared memory (bytes)
SM_SMEM = 233472         # an H100 multiprocessor's shared memory (bytes)
BLOCK_RESERVED = 1024    # bytes the runtime reserves a block
MAX_THREADS_SM = 2048    # an H100 multiprocessor's threads


def mixed(n):
    """``fftblock::mixed_plan``: a radix above 4."""
    return max(make_plan(n)) > 4


def kept(n):
    """``fftblock::kRowEPT``: values a thread holds in a stage."""
    return 8 if mixed(n) else 16


def curl_cols(n):
    """``curl_cols`` of curl_ifft_x.cu: T, the columns a tile."""
    T = 1
    while 2 * T <= K_CURL_MAX_COLS and n * 2 * T <= K_CURL_TILE:
        T *= 2
    return T


def launch(n):
    """(T, threads, shared memory bytes) of ``launch``: the slot's six
    planes, the work tile of K_CURL_GROUP components, the mbarrier."""
    T = curl_cols(n)
    kE = kept(n)
    threads = -(-K_CURL_GROUP * n * T // (kE * 32)) * 32
    return T, threads, 4 * (6 + 2 * K_CURL_GROUP) * n * T + 8


def blocks_per_sm(n):
    """Blocks a multiprocessor holds by shared memory and threads (the
    launch bounds leave registers for them)."""
    _, threads, smem = launch(n)
    return min(SM_SMEM // (smem + BLOCK_RESERVED), MAX_THREADS_SM // threads)


def groups(with_state):
    """(j0, gc) of the tile's transforms: output components j0..j0+gc-1."""
    jobs = 6 if with_state else 3
    return [(j0, min(K_CURL_GROUP, jobs - j0))
            for j0 in range(0, jobs, K_CURL_GROUP)]


ENVELOPE = [n for n in range(2, 1025) if p3.curl_fused_ok(n)]


def test_launch_fits_over_the_envelope():
    """Every n the wrapper takes: the threads hold the work tile's values
    within the instance's launch bounds, every thread keeps one column in
    the passes over the slot (threads a multiple of T), shared memory fits
    a block, the work tile's indices stay below FastDiv's 2^16, and a row
    segment spans a 32-byte sector from n = 512 down (16 bytes above)."""
    assert len(ENVELOPE) > 500
    for n in ENVELOPE:
        T, threads, smem = launch(n)
        kE = kept(n)
        assert T & (T - 1) == 0 and T <= K_CURL_MAX_COLS
        assert threads * kE >= K_CURL_GROUP * n * T and threads % 32 == 0
        assert threads <= K_CURL_GROUP * K_CURL_TILE // kE <= 1024
        assert threads % T == 0
        assert smem <= MAX_SMEM
        assert n * K_CURL_GROUP * T < 2 ** 16
        assert T * 4 >= (32 if n <= 512 else 16), n


@pytest.mark.parametrize("n,want", [
    (512, (8, 512, 1)),     # the 512^3 cell: a 32-byte sector a segment
    (256, (16, 512, 1)),    # 256^3: 64 bytes
    (1024, (4, 512, 1)),    # 16 bytes: a slot of 96 KB at most
    (320, (8, 640, 2)),     # radix 5 (the mixed instance)
    (640, (4, 640, 2)),
    (1000, (4, 1024, 1)),
    (16, (16, 32, 20))])
def test_main_path_geometry(n, want):
    T, threads, _ = launch(n)
    assert (T, threads, blocks_per_sm(n)) == want


# -- the walk -----------------------------------------------------------------

def tiles_of(Q, T):
    """(q0, w) of every tile."""
    q0 = np.arange(0, Q, T)
    return q0, np.minimum(T, Q - q0)


def walk(n, Q, bases):
    """The kernel's loads over every tile: each of the six planes' coverage
    of its (3, n, Q) array (re planes from ur, im planes from ui, at byte
    bases ``bases``), the 16-byte and single-value copies as (global byte
    address, slot byte offset) and the output coverage of the (6, n, Q)
    pair by the last stage's writes (columns 3j + c < 3w, every k)."""
    T = curl_cols(n)
    PL = n * T
    plane = n * Q
    cov = [np.zeros(3 * plane, int) for _ in range(2)]
    out = np.zeros(6 * plane, int)
    whole, single = [], []
    r = np.arange(n)[:, None]
    for q0, w in zip(*tiles_of(Q, T)):
        for p in range(6):
            x, comp = divmod(p, 3)
            base, g0 = bases[x], comp * plane + q0
            chunks = (Q * 4) % 16 == 0 and (w * 4) % 16 == 0 and \
                (base + g0 * 4) % 16 == 0
            c = np.arange(0, w, 4 if chunks else 1)[None, :]
            g = g0 + r * Q + c
            off = (p * PL + r * T + c) * 4
            copies = np.stack([(base + g * 4).ravel(), off.ravel()], -1)
            (whole if chunks else single).append(copies)
            span = 4 if chunks else 1
            np.add.at(cov[x], (g[..., None] + np.arange(span)).ravel(), 1)
        for j0, gc in groups(True):
            c = np.arange(gc * w)
            g = (j0 + c % gc)[None, :] * plane + r * Q + q0 + c // gc
            np.add.at(out, g.ravel(), 1)
    empty = np.zeros((0, 2), int)
    return (cov, out, np.concatenate(whole or [empty]),
            np.concatenate(single or [empty]), 6 * PL * 4)


# (n, n1, h): the 512^3 cell's x length on several tiles with Q on the
# grid, Q odd (segments off the grid, a ragged last tile), n = 1000's
# 8-byte segments, radix 5 (320), small n with wide tiles
WALK_CASES = [(512, 8, 16), (512, 3, 43), (256, 5, 13), (1024, 2, 10),
              (1000, 3, 5), (320, 8, 65), (16, 3, 5), (40, 7, 3)]


@pytest.mark.parametrize("mis", [0, 1, 2, 3])
@pytest.mark.parametrize("n,n1,h", WALK_CASES)
def test_walk_covers_every_value_once(n, n1, h, mis):
    """Bases ``mis`` values off the grid, the im plane's one more."""
    Q = n1 * h
    bases = (4 * mis, 4 * ((mis + 1) % 4))
    cov, out, whole, single, slot_bytes = walk(n, Q, bases)
    assert all((cv == 1).all() for cv in cov)
    assert (out == 1).all()
    for copies, size in ((whole, 16), (single, 4)):
        addr, off = copies[:, 0], copies[:, 1]
        assert (addr % size == 0).all() and (off % size == 0).all()
        assert (off >= 0).all() and (off + size <= slot_bytes).all()
    if Q % 4 == 0 and curl_cols(n) >= 4:
        # rows on the grid: a plane goes whole unless its base is off it
        off = sum(base % 16 != 0 for base in bases)
        assert len(single) == off * 3 * n * Q


# -- the kernel end to end ----------------------------------------------------

def form_curl(a, b, K, bs):
    """The kernel's curl of one (row, column) set: a, b the re and im of
    the three components (float32), K = (kx, ky, kz); returns (re, im) of
    the three components, each rounded to float32 as it is computed."""
    re, im = [], []
    kinv = F32(1)
    if bs:
        ksq = F32(F32(F32(K[0] * K[0]) + F32(K[1] * K[1])) + F32(K[2] * K[2]))
        kinv = F32(1) / np.where(ksq == 0, F32(1), ksq).astype(F32)
    for c in range(3):
        c1, c2 = (c + 1) % 3, (c + 2) % 3
        vr = -F32(F32(K[c1] * b[c2]) - F32(K[c2] * b[c1]))
        vi = F32(F32(K[c1] * a[c2]) - F32(K[c2] * a[c1]))
        re.append(F32(vr * kinv))
        im.append(F32(vi * kinv))
    return re, im


def kernel_model(ur, ui, k0, k1, k2, with_state, bs):
    """The kernel on a (3, n, n1, h) float32 pair: every tile loaded into
    the slot (the walk checks how), the curl formed from it; then for each
    group of output components (``groups``) the work tile (row r's column
    gc·j + g the component j0 + g), all but the last stage by the float32
    model, the last stage in the kernel's order (or the pass after a
    pair-sum stage), stored by column and row.  Returns the (3 or 6, n,
    n1, h) pair, each output value's write count and the curl before its
    transform."""
    _, n, n1, h = ur.shape
    Q = n1 * h
    T = curl_cols(n)
    xr, xi = ur.reshape(3, n, Q), ui.reshape(3, n, Q)
    plan = make_plan(n)
    fused = plan[-1] <= (7 if mixed(n) else 4)
    twr, twi = twiddles(n, 1)
    scale = 1.0 / n
    oc = 6 if with_state else 3
    y = np.full((oc, n, Q), np.nan, np.complex64)
    count = np.zeros((oc, n, Q), int)
    curls = np.zeros((3, n, Q), np.complex64)
    for q0, w in zip(*tiles_of(Q, T)):
        w = int(w)
        sr, si = xr[:, :, q0:q0 + w], xi[:, :, q0:q0 + w]
        q = q0 + np.arange(w)
        K = (k0[:, None], k1[q // h][None, :], k2[q % h][None, :])
        re, im = form_curl(sr, si, K, bs)
        jobs = np.concatenate([np.stack([a + 1j * b for a, b in zip(re, im)]),
                               sr + 1j * si]).astype(np.complex64)
        curls[:, :, q0:q0 + w] = jobs[:3]
        for j0, gc in groups(with_state):
            ncol, pitch = gc * w, gc * T
            work = np.zeros((n, pitch), np.complex64)
            work[:, :ncol] = jobs[j0:j0 + gc].transpose(1, 2, 0) \
                .reshape(n, ncol)
            cr = work[:, :ncol].real.astype(F32)
            ci = work[:, :ncol].imag.astype(F32)
            Ns = 1
            for R in plan[:-1] if fused else plan:
                if R >= 11:
                    cr, ci = pairsum_stage(cr, ci, Ns, R, twr, twi)
                else:
                    cr, ci = register_stage(cr, ci, Ns, R, 1, twr, twi)
                Ns *= R
            work[:, :ncol] = cr + 1j * ci
            out = np.zeros(n * pitch, np.complex64)
            if fused:
                writes = last_stage_cols(work.ravel(), n, ncol, pitch,
                                         plan[-1], 1, scale, out)
            else:
                out.reshape(n, pitch)[:, :ncol] = \
                    work[:, :ncol] * F32(scale)
                writes = np.zeros(n * pitch, int)
                writes.reshape(n, pitch)[:, :ncol] = 1
            writes = writes.reshape(n, pitch)
            assert (writes[:, :ncol] == 1).all()
            assert (writes[:, ncol:] == 0).all()
            c = np.arange(ncol)
            out = out.reshape(n, pitch)[:, :ncol]
            for g in range(gc):
                cols = c[c % gc == g]
                y[j0 + g, :, q0 + cols // gc] = out[:, cols].T
                count[j0 + g, :, q0 + cols // gc] += 1
    shape = (oc, n, n1, h)
    return y.reshape(shape), count.reshape(shape), curls.reshape(3, n, n1, h)


# (n, n1, h): radix-4 (16), radix-2 (32) and radix-3 (12) last stages in
# the plain instance; radix 5 (40) and 7 (28) in the mixed one; pair-sum
# stages last (22 = 2·11, 129 = 3·43); the 512^3 cell's x length on a few
# columns; Q odd (ragged tiles) and n = 1000's two-column tiles
MODEL_CASES = [(16, 4, 5), (32, 3, 3), (12, 5, 7), (40, 3, 4), (28, 2, 9),
               (22, 3, 5), (129, 2, 3), (512, 1, 6), (1000, 1, 3)]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("bs", [False, True])
@pytest.mark.parametrize("n,n1,h", MODEL_CASES)
def test_kernel_model_matches_float64(n, n1, h, bs, with_state):
    rng = np.random.default_rng(n * 31 + n1 * 7 + h)
    shape = (3, n, n1, h)
    ur, ui = (rng.standard_normal(shape).astype(F32) for _ in "ri")
    k0 = (np.fft.fftfreq(n, 1 / n) * 1.0).astype(F32)
    k1 = (np.fft.fftfreq(n1, 1 / n1) * 0.5).astype(F32)
    k2 = (np.arange(h) * 2.0).astype(F32)
    y, count, curl = kernel_model(ur, ui, k0, k1, k2, with_state, bs)
    assert (count == 1).all()
    t64 = [torch.from_numpy(v.astype(np.float64)) for v in (ur, ui, k0, k1,
                                                            k2)]
    K = p3.kvecs(*t64[2:])
    cr, ci = p3._curl_pair(t64[0], t64[1], K)
    if bs:
        inv = p3.inv_ksq(*t64[2:])
        cr, ci = cr * inv, ci * inv
    c64 = torch.complex(cr, ci).numpy()
    err = np.abs(curl - c64).max() / np.abs(c64).max()
    assert err <= 1e-6, f"curl rel err {err:.3e}"
    ref = torch.complex(*p3.curl_ifft_x_ref(*t64, with_state, bs)).numpy()
    err = np.abs(y - ref).max() / np.abs(ref).max()
    assert err <= 1e-5, f"rel err {err:.3e}"
