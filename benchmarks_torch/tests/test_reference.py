"""The plain references against numpy in float64 at 16³–32³: the
transform, the layouts, the TF32 rounding of the control, NS3D's
right-hand side under each rule against an independent numpy one that
dealiases on the full spectrum, and its RK4 step under the 2/3 rule."""

import math

import numpy as np
import pytest
import torch

from reference import layouts, tf32_round
from reference.ns3d import NS3D
from reference.r2c import R2C


@pytest.mark.parametrize("N", [(16, 16, 16), (32, 24, 20), (16, 32, 32)])
def test_r2c_against_numpy(N):
    u = np.random.default_rng(7).standard_normal(N)
    X = R2C(N).fftn(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(X, np.fft.rfftn(u), rtol=0, atol=1e-12)
    v = R2C(N).ifftn(torch.from_numpy(np.fft.rfftn(u))).numpy()
    np.testing.assert_allclose(v, u, rtol=0, atol=1e-14)


def test_packed_to_complex_against_numpy():
    N = (16, 12, 8)
    X = np.fft.rfftn(np.random.default_rng(3).standard_normal((2,) + N),
                     axes=(1, 2, 3))
    h = N[2] // 2
    q = X[..., 0] + 1j * X[..., h]          # X0 + i·X_Nyq
    S = np.stack([np.concatenate([q.real[..., None], X.real[..., 1:h]], -1),
                  np.concatenate([q.imag[..., None], X.imag[..., 1:h]], -1)])
    got = layouts.to_complex(torch.from_numpy(S)).numpy()
    np.testing.assert_allclose(got, X, rtol=0, atol=1e-12)


def test_tf32_round():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -1 - 2 ** -12,
                      3.14159265], dtype=torch.float32)
    got = tf32_round(x)
    assert got[:4].tolist() == [1.0, 1.0, 1 + 2 ** -9, -1.0]
    y = torch.randn(10000, generator=torch.Generator().manual_seed(1))
    r = tf32_round(y)
    assert float(((r - y).abs() / y.abs()).max()) <= 2 ** -11
    mant = r.view(torch.int32) & 0x1FFF
    assert int(mant.abs().max()) == 0
    z = torch.complex(y[:10], y[10:20])
    assert torch.equal(tf32_round(z).real, tf32_round(y[:10]))


# -- an independent numpy NS3D right-hand side -------------------------------

def _split(X, M):
    """Full-spectrum zero-pad of every axis N -> M, Nyquist split."""
    for ax, m in enumerate(M):
        n = X.shape[ax]
        if m == n:
            continue
        h = n // 2
        lo, ny, hi = np.split(X, [h, h + 1], axis=ax)
        z = np.zeros(X.shape[:ax] + (m - n - 1,) + X.shape[ax + 1:],
                     complex)
        X = np.concatenate([lo, ny / 2, z, ny / 2, hi], axis=ax)
    return X


def _fold(X, N):
    """Full-spectrum truncation of every axis M -> N, Nyquist summed."""
    for ax, n in enumerate(N):
        m = X.shape[ax]
        if m == n:
            continue
        h = n // 2
        idx = list(range(h)) + [h] + list(range(m - h + 1, m))
        Y = np.take(X, idx, axis=ax)
        sl = [slice(None)] * X.ndim
        sl[ax] = h
        Y[tuple(sl)] += np.take(X, m - h, axis=ax)
        X = Y
    return X


def _numpy_rhs(U, N, nu, rule):
    """dÛ/dt with u and ω made on the full spectrum (split Nyquist) and
    the product folded back on it (summed Nyquist)."""
    N = tuple(N)
    k = [np.fft.fftfreq(n, 1 / n) for n in N]
    K = np.meshgrid(*k, indexing="ij")
    M = tuple(3 * n // 2 for n in N) if rule == "3/2-rule" else N
    keep = np.ones(N, bool)
    if rule == "2/3-rule":
        for x, n in zip(K, N):
            keep &= np.abs(x) < (2 / 3) * (n // 2)
    nf = N[2] // 2 + 1
    # the half axis' wavenumbers are 0..N2/2 (its Nyquist +N2/2)
    Kh = [K[0][..., :nf], K[1][..., :nf],
          np.broadcast_to(np.arange(nf), K[2][..., :nf].shape)]
    ksqh = sum(x * x for x in Kh)

    def phys(Uh):
        full = np.fft.fftn(np.fft.irfftn(Uh, s=N, axes=(0, 1, 2)))
        return np.real(np.fft.ifftn(_split(full, M))) \
            * (math.prod(M) / math.prod(N))

    def spec(f):
        X = _fold(np.fft.fftn(f), N) * (math.prod(N) / math.prod(M))
        return (X * keep)[..., :nf]

    u = [phys(U[c]) for c in range(3)]
    w = [phys(1j * (Kh[a] * U[b] - Kh[b] * U[a]))
         for a, b in ((1, 2), (2, 0), (0, 1))]
    F = np.stack([spec(u[a] * w[b] - u[b] * w[a])
                  for a, b in ((1, 2), (2, 0), (0, 1))])
    div = sum(Kh[c] * F[c] for c in range(3)) / np.where(ksqh == 0, 1, ksqh)
    return F - np.stack([Kh[c] * div for c in range(3)]) - nu * ksqh * U


def _state(N, seed=11):
    """A random spectral state of a real field with its Nyquist planes
    zero (where the derivative's sign convention would matter)."""
    U = np.fft.rfftn(np.random.default_rng(seed).standard_normal((3,) + N),
                     axes=(1, 2, 3))
    U[:, N[0] // 2] = 0
    U[:, :, N[1] // 2] = 0
    U[..., N[2] // 2] = 0
    return U


@pytest.mark.parametrize("rule", ["2/3-rule", "3/2-rule"])
@pytest.mark.parametrize("N", [(16, 16, 16), (16, 20, 24)])
def test_ns3d_rhs_against_numpy(rule, N):
    U = _state(N)
    ref = NS3D(N, [2 * np.pi] * 3, 0.01, 0.05, rule, "float64", "cpu")
    got = ref.rhs(torch.from_numpy(U)).numpy()
    want = _numpy_rhs(U, N, 0.01, rule)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-13)


def test_ns3d_rk4_step_against_numpy():
    N, dt = (16, 16, 16), 0.05
    U = _state(N)
    ref = NS3D(N, [2 * np.pi] * 3, 0.01, dt, "2/3-rule", "float64", "cpu")

    def f(V):
        return _numpy_rhs(V, N, 0.01, "2/3-rule")
    k1 = f(U)
    k2 = f(U + 0.5 * dt * k1)
    k3 = f(U + 0.5 * dt * k2)
    k4 = f(U + dt * k3)
    want = U + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    got = ref.step(torch.from_numpy(U)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-13)


@pytest.mark.parametrize("N", [(16, 16, 16), (16, 20, 24)])
def test_padded_transforms_against_numpy(N):
    """The 3/2 rule's pad and truncation (the z-Nyquist plane the alias
    sum) on the full spectrum of real fields."""
    rng = np.random.default_rng(5)
    ref = NS3D(N, [2 * np.pi] * 3, 0.01, 0.05, "3/2-rule", "float64", "cpu")
    M = ref.M
    X = np.fft.rfftn(rng.standard_normal(N))
    got = ref.ifft(torch.from_numpy(X)).numpy()
    full = np.fft.fftn(np.fft.irfftn(X, s=N, axes=(0, 1, 2)))
    want = np.real(np.fft.ifftn(_split(full, M))) \
        * (math.prod(M) / math.prod(N))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    f = rng.standard_normal(M)
    got = ref.fft(torch.from_numpy(f)).numpy()
    want = (_fold(np.fft.fftn(f), N)
            * (math.prod(N) / math.prod(M)))[..., :N[2] // 2 + 1]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)


def test_ns3d_taylor_green_energy_and_decay():
    ref = NS3D((16, 16, 16), [2 * np.pi] * 3, 0.000625, 0.01, "2/3-rule",
               "float64", "cpu")
    U = ref.taylor_green("cpu")
    assert ref.energy(U) == pytest.approx(0.125, rel=1e-13)
    U2, e = ref.run(U, 4, 2)
    assert e.shape == (2,) and 0 < e[1] < e[0] < 0.125
