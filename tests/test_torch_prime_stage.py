"""A float32 numpy model of ``fft_last.cu``'s Stockham plan with its pair-sum
prime stage, against numpy's float64 FFT.

The CUDA kernel (``mpifft4py_tpu_torch/ops/csrc/fft_last.cu``, rows 10 and
20) runs only on the card.  Its plan (``fft_block.cuh`` ``make_plan``: one
radix 2 where the power of two is odd, radix 4, then 3, 5, 7 and each prime
factor p >= 11 in turn) is modelled here stage by stage, with the kernel's
index arithmetic and float32 rounding after every operation:

- a register stage (radix 2, 3, 4, 5, 7): input t of butterfly j (k = j mod
  Ns) is x[j + t·n/R] times tw[t·k·n/(Ns·R)], the R-point DFT, output q to
  slot (j/Ns)·Ns·R + k + q·Ns;
- the pair-sum stage (p >= 11, ``fftblock::stage_pairsum``): pass 1 multiplies
  each input by the same pre-twiddle in place; pass 2 computes the output
  pair (q, p − q) of a butterfly from the symmetric sums and differences,
  a_q = x_0 + Σ_t cos(2π·tq/p)·(x_t + x_{p−t}) and b_q = Σ_t
  sin(2π·tq/p)·(x_t − x_{p−t}) over t = 1..(p − 1)/2, the cosines and
  sines read from the n-point table at tw[m·n/p] with m = tq mod p advanced
  by addition; y_q = a_q + i·b_q, y_{p−q} = a_q − i·b_q (the table's sine
  carries the direction's sign); q = 0 gives y_0 (m stays 0).  For p
  > 127 (primes only the dense tier's lengths have) a_q and b_q are summed
  with Kahan's compensation: uncompensated, n = 1021's round trip came to
  8e-7 of the 1e-6 limit in this model (2e-7 compensated).

Every ``supported_c2c`` n (the planar kernel's envelope) with a prime factor
>= 11, in both directions, and lengths with primes up to 1021 that only the
dense tier's complex64 instance takes (``dense.c2c_ok``: 2 <= n <= 1024):
forward within 1e-5 of max |float64 FFT| and round trip within 1e-6 of max
|x|, the kernel's tolerances on the card (chip_smoke.py's envelope sweep).
The model catches index and accuracy faults of the stage before chip time;
the kernel itself is held to ``torch.fft`` on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.  Run on the CPU:

    python -m pytest tests/test_torch_prime_stage.py -q
"""

import numpy as np
import pytest

from mpifft4py_tpu_torch.ops.fft3d import supported_c2c

F32 = np.float32
KAHAN_ABOVE = 127   # fftblock::kPairSumExact: larger p compensate a_q, b_q


def make_plan(n):
    """``fftblock::make_plan``: the radix sequence for n."""
    a, m = 0, n
    while m % 2 == 0:
        m //= 2
        a += 1
    plan = [2] if a % 2 else []
    plan += [4] * (a // 2)
    f = 3
    while f <= m:
        while m % f == 0:
            plan.append(f)
            m //= f
        f += 2
    return plan


def twiddles(n, sign):
    """The kernel's float32 table tw[m] = exp(sign·2πi·m/n), computed in
    float64 (``fft3d._twiddles``)."""
    ang = sign * 2.0 * np.pi * np.arange(n) / n
    return np.cos(ang).astype(F32), np.sin(ang).astype(F32)


def cmul(ar, ai, br, bi):
    return F32(ar * br) - F32(ai * bi), F32(ar * bi) + F32(ai * br)


def pre_twiddle(xr, xi, Ns, R, twr, twi):
    """Input t of butterfly j times tw[t·k·n/(Ns·R)], k = j mod Ns (none
    where t = 0 or k = 0), in place on rows r = j + t·n/R."""
    n = xr.shape[0]
    stride = n // R
    r = np.arange(n)
    t, k = r // stride, (r % stride) % Ns
    idx = t * k * (n // (Ns * R))
    on = (t > 0) & (k > 0)
    yr, yi = cmul(xr[on], xi[on], twr[idx[on], None], twi[idx[on], None])
    xr, xi = xr.copy(), xi.copy()
    xr[on], xi[on] = yr, yi
    return xr, xi


def scatter(n, Ns, R, yr, yi):
    """Outputs (R, n/R, cols) of butterflies j to slot (j/Ns)·Ns·R + k +
    q·Ns."""
    stride = n // R
    j = np.arange(stride)
    d = (j // Ns) * Ns * R + j % Ns
    out_r = np.empty((n,) + yr.shape[2:], F32)
    out_i = np.empty_like(out_r)
    for q in range(R):
        out_r[d + q * Ns], out_i[d + q * Ns] = yr[q], yi[q]
    return out_r, out_i


def register_stage(xr, xi, Ns, R, sign, twr, twi):
    """stage<R>: the pre-twiddle, then an R-point DFT in float32 (the
    kernel's butterflies round differently, at the same order of
    magnitude)."""
    n = xr.shape[0]
    xr, xi = pre_twiddle(xr, xi, Ns, R, twr, twi)
    vr = xr.reshape((R, n // R) + xr.shape[1:])
    vi = xi.reshape(vr.shape)
    ang = sign * 2.0 * np.pi * np.outer(np.arange(R), np.arange(R)) / R
    cr, ci = np.cos(ang).astype(F32), np.sin(ang).astype(F32)
    yr = np.zeros_like(vr)
    yi = np.zeros_like(vi)
    for q in range(R):
        for t in range(R):
            pr, pi = cmul(vr[t], vi[t], cr[q, t], ci[q, t])
            yr[q] += pr
            yi[q] += pi
    return scatter(n, Ns, R, yr, yi)


def pairsum_stage(xr, xi, Ns, p, twr, twi):
    """``stage_pairsum``: pass 1 pre-twiddles in place; pass 2 computes
    each butterfly's output pairs (q, p − q) from x_t ± x_{p−t} with the
    table's cosines and (signed) sines at tw[m·n/p], m = tq mod p."""
    n = xr.shape[0]
    xr, xi = pre_twiddle(xr, xi, Ns, p, twr, twi)
    vr = xr.reshape((p, n // p) + xr.shape[1:])
    vi = xi.reshape(vr.shape)
    H = (p - 1) // 2
    yr = np.empty_like(vr)
    yi = np.empty_like(vi)
    q = np.arange(H + 1)              # q = 0 sums y_0 with m = 0
    ex = (slice(None),) + (None,) * (vr.ndim - 1)
    ar = np.broadcast_to(vr[0], (H + 1,) + vr.shape[1:]).copy()
    ai = np.broadcast_to(vi[0], ar.shape).copy()
    br = np.zeros_like(ar)
    bi = np.zeros_like(ar)
    acc = [ar, ai, br, bi]
    comp = [np.zeros_like(ar) for _ in acc]
    m = q.copy()
    for t in range(1, H + 1):
        spr, spi = F32(vr[t] + vr[p - t]), F32(vi[t] + vi[p - t])
        dmr, dmi = F32(vr[t] - vr[p - t]), F32(vi[t] - vi[p - t])
        c, s = twr[m * (n // p)][ex], twi[m * (n // p)][ex]
        for i, term in enumerate((F32(c * spr), F32(c * spi), F32(s * dmr),
                                  F32(s * dmi))):
            if p > KAHAN_ABOVE:         # kahan_add
                y = term - comp[i]
                tot = acc[i] + y
                comp[i] = (tot - acc[i]) - y
                acc[i] = tot
            else:
                acc[i] = acc[i] + term
        m = m + q
        m = np.where(m >= p, m - p, m)
    ar, ai, br, bi = acc
    yr[q], yi[q] = ar - bi, ai + br
    yr[p - q[1:]], yi[p - q[1:]] = (ar + bi)[1:], (ai - br)[1:]
    return scatter(n, Ns, p, yr, yi)


def model_fft(x, inverse=False):
    """The kernel's c2c along axis 0 of complex x (n, cols): float32
    Stockham stages, 1/n folded into the inverse's store."""
    n = x.shape[0]
    sign = 1 if inverse else -1
    twr, twi = twiddles(n, sign)
    xr, xi = x.real.astype(F32), x.imag.astype(F32)
    Ns = 1
    for R in make_plan(n):
        stage = pairsum_stage if R >= 11 else (
            lambda a, b, Ns, R, c, d: register_stage(a, b, Ns, R, sign, c, d))
        xr, xi = stage(xr, xi, Ns, R, twr, twi)
        Ns *= R
    if inverse:
        xr, xi = xr * F32(1.0 / n), xi * F32(1.0 / n)
    return xr + 1j * xi.astype(np.complex64)


def _largest_prime(n):
    f, m, big = 2, n, 1
    while m > 1:
        while m % f == 0:
            m //= f
            big = f
        f += 1
    return big


PRIME_NS = [n for n in range(8, 1025)
            if supported_c2c(n) and _largest_prime(n) >= 11]
# lengths only the dense tier's complex64 instance takes (primes > 127)
DENSE_NS = [131, 257, 2 * 509, 1021]


def _check(n, inverse, cols=3):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n, cols))
         + 1j * rng.standard_normal((n, cols))).astype(np.complex64)
    ref = (np.fft.ifft if inverse else np.fft.fft)(
        x.astype(np.complex128), axis=0)
    y = model_fft(x, inverse)
    fwd = float(np.abs(y - ref).max() / np.abs(ref).max())
    back = model_fft(y.astype(np.complex64), not inverse)
    trip = float(np.abs(back - x).max() / np.abs(x).max())
    assert fwd <= 1e-5, f"n={n}: forward rel err {fwd:.3e}"
    assert trip <= 1e-6, f"n={n}: round trip rel err {trip:.3e}"


def test_plan_has_prime_stages():
    """The parametrisation covers the envelope's prime stages: 11..127,
    one or two of them (121 = 11²), after register stages or alone."""
    primes = {_largest_prime(n) for n in PRIME_NS}
    assert min(primes) == 11 and max(primes) == 127
    assert make_plan(121) == [11, 11] and make_plan(1016) == [2, 4, 127]
    assert make_plan(129) == [3, 43] and len(PRIME_NS) > 100


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", PRIME_NS)
def test_pairsum_plan_matches_float64(n, inverse):
    _check(n, inverse)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", DENSE_NS)
def test_pairsum_plan_dense_primes(n, inverse):
    _check(n, inverse)


def test_register_plan_matches_float64():
    """The model's register stages alone (256 = 4⁴, 384 = 2·4³·3, 280 =
    2·4·5·7), so a fault in the pair-sum stage is not masked by them."""
    for n in (256, 384, 280):
        _check(n, False)
