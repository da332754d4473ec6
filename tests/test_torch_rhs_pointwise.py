"""The complex layout's pointwise right-hand side (``ops.fft3d.rhs_*``) on
the CPU: the routes that run the twins, which must be the solver's eager
expressions exactly, and the wrappers' checks.  The kernels themselves are
held against the twins on the card (``test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch

from mpifft4py_tpu_torch.ops import fft3d as p3

SHAPE = (3, 6, 5, 4)          # (3, N0, N1, nf), ragged
NAMES = ("rhs_curl", "rhs_cross", "rhs_leray_visc")


def _field(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if dtype.is_complex:
        x = x + 1j * rng.standard_normal(shape)
    return torch.from_numpy(x).to(dtype)


def _kvecs(dtype, shape=SHAPE):
    """Scaled 1-D wavenumbers of (N0, N1, nf), k = 0 included."""
    n0, n1, nf = shape[1:]
    k = (np.fft.fftfreq(n0, 1 / n0), 0.5 * np.fft.fftfreq(n1, 1 / n1),
         2.0 * np.arange(nf))
    return tuple(torch.from_numpy(v).to(dtype) for v in k)


def _eager(name, dtype):
    """(wrapper's output, the eager expression NavierStokes3D.rhs held
    before the kernels) on the same inputs."""
    real = torch.float64 if dtype in (torch.complex128, torch.float64) \
        else torch.float32
    k0, k1, k2 = _kvecs(real)
    K0, K1, K2v = k0[:, None, None], k1[None, :, None], k2[None, None, :]
    if name == "rhs_cross":
        U, W = _field(SHAPE, dtype, 1), _field(SHAPE, dtype, 2)
        return p3.rhs_cross(U, W), p3.cross(U, W)
    U_hat = _field(SHAPE, dtype, 1)
    if name == "rhs_curl":
        return (p3.rhs_curl(U_hat, k0, k1, k2),
                1j * p3.kcross((K0, K1, K2v), U_hat))
    nu = 0.000625
    F_hat = _field(SHAPE, dtype, 2)
    ksq = K0 * K0 + K1 * K1 + K2v * K2v
    div = ((K0 * F_hat[0] + K1 * F_hat[1] + K2v * F_hat[2])
           / torch.where(ksq == 0, 1, ksq))
    dU = F_hat - torch.stack([K0 * div, K1 * div, K2v * div])
    dU = dU - (nu * ksq)[None] * U_hat
    return p3.rhs_leray_visc(F_hat, U_hat, k0, k1, k2, nu), dU


@pytest.mark.parametrize("name,dtype", [
    ("rhs_curl", torch.complex64), ("rhs_curl", torch.complex128),
    ("rhs_cross", torch.float32), ("rhs_cross", torch.float64),
    ("rhs_leray_visc", torch.complex64), ("rhs_leray_visc", torch.complex128)])
def test_twin_routes_are_the_eager_expressions(name, dtype):
    before = dict(p3.LAUNCHES)
    got, want = _eager(name, dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert p3.LAUNCHES == before          # no launch on the CPU


def test_launch_counters_are_registered():
    assert all(n in p3.LAUNCHES and n in p3.__all__ for n in NAMES)


def _bad_calls():
    u = _field(SHAPE, torch.complex64, 1)
    k = _kvecs(torch.float32)
    short = (k[0], k[1], k[2][:-1])
    a = _field(SHAPE, torch.float32, 1)
    huge = torch.zeros(1, dtype=torch.complex64).expand(3, 2 ** 16, 2 ** 15, 2)
    return {
        "curl, not a 3-stack": (p3.rhs_curl, (u[:2], *k), ValueError),
        "curl, k2 too short": (p3.rhs_curl, (u, *short), ValueError),
        "curl, float64 k with complex64": (
            p3.rhs_curl, (u, *_kvecs(torch.float64)), TypeError),
        "curl, a real stack": (p3.rhs_curl, (a, *k), TypeError),
        "curl, beyond 32-bit indices": (
            p3.rhs_curl, (huge, *_kvecs(torch.float32, huge.shape)),
            ValueError),
        "cross, shapes differ": (p3.rhs_cross, (a, a[:, :-1]), ValueError),
        "cross, not a 3-stack": (p3.rhs_cross, (a[:2], a[:2]), ValueError),
        "cross, dtypes differ": (p3.rhs_cross, (a, a.double()), TypeError),
        "cross, integers": (p3.rhs_cross, (a.int(), a.int()), TypeError),
        "leray, shapes differ": (
            p3.rhs_leray_visc, (u, u[:, :-1], *k, 0.1), ValueError),
        "leray, k0 too long": (
            p3.rhs_leray_visc, (u, u, torch.zeros(7), k[1], k[2], 0.1),
            ValueError),
        "leray, dtypes differ": (
            p3.rhs_leray_visc, (u, u.to(torch.complex128), *k, 0.1),
            TypeError),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_wrappers_reject_wrong_inputs(case):
    fn, args, exc = _bad_calls()[case]
    with pytest.raises(exc):
        fn(*args)
