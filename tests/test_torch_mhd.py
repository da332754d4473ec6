"""The port's MHD3D and its cross2 kernel variant against the JAX package.

Kernels: ``cross_rfft_zy_packed(a, b, c, d)`` (cross2, A × B + C × D) and
the z-only products ``cross_rfft_z`` against the reference's Pallas
functions in interpret mode (row 16's ``cross_rfft_z_packed``, ``dif=False``)
at 1e-5 of max |reference|.  The solver: the port's complex step under the
2/3 and the 3/2 rule, and its packed step, against the reference's jitted
complex step from the same 6-component state, after 1 and 3 RK4 steps, at
2e-5 of max |reference|; the energies against float64 numpy.  Oracles in
the port: b = 0 is NS3D; ∇·b stays at round-off.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mpifft4py_tpu import slab as jslab
from mpifft4py_tpu.models.mhd import MHD3D as JMHD
from mpifft4py_tpu.ops import pallas_fft3d as jp3
from mpifft4py_tpu_torch import (packed_state_from_reference,
                                 state_from_reference)
from mpifft4py_tpu_torch import slab as tslab
from mpifft4py_tpu_torch.models import MHD3D as TMHD
from mpifft4py_tpu_torch.models import NavierStokes3D as TNS
from mpifft4py_tpu_torch.ops import fft3d as tp3
from test_torch_packed import _close, _f32, _t

TAU = 2 * np.pi
STEP_TOL = 2e-5
N = (16, 16, 256)
KW = dict(nu=0.01, eta=0.02, dt=0.01, integrator="RK4")


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


# -- the kernels --------------------------------------------------------------------

def test_cross2_rfft_zy_packed_matches_pallas(rng):
    ins = [_f32(rng, (3, 1, 64, 256)) for _ in range(4)]
    assert jp3._cross_zy_oneshot_ok(64, 256, True)     # the one-shot kernel
    _close(tp3.cross_rfft_zy_packed(*map(_t, ins)),
           jp3.cross_rfft_zy_packed(*map(jnp.asarray, ins)))


@pytest.mark.parametrize("two", [False, True])
def test_cross_rfft_z_matches_z_only_pallas(rng, two):
    """Row 16's function (the product and the packed z r2c, no y stage) is
    what the port's cross kernel computes."""
    ins = [_f32(rng, (3, 4, 16, 256)) for _ in range(4 if two else 2)]
    _close(tp3.cross_rfft_z(*map(_t, ins)),
           jp3.cross_rfft_z_packed(*map(jnp.asarray, ins), dif=False))


# -- the solver ---------------------------------------------------------------------

def _fft_pair(precision="single"):
    L = np.array([TAU] * 3)
    return (jslab.R2C(np.array(N), L, 1, precision),
            tslab.R2C(np.array(N), L, None, precision, device="cpu"))


def _k(J):
    k0, k1, k2 = (np.asarray(k, np.float64) for k in J._complex_k_args())
    return k0[:, None, None], k1[None, :, None], k2[None, None, :]


def _energies64(S):
    """(0.5 <|u|²>, 0.5 <|b|²>) in float64: the diagnostics' oracle."""
    s = np.fft.irfftn(np.asarray(S).astype(np.complex128), s=N,
                      axes=(1, 2, 3))
    return (0.5 * np.mean(np.sum(s[:3] ** 2, axis=0)),
            0.5 * np.mean(np.sum(s[3:] ** 2, axis=0)))


def _state(J, seed=7):
    """The reference's Taylor–Green MHD state plus a seeded solenoidal
    perturbation of both fields, 2/3-rule masked, complex64 numpy."""
    K = _k(J)
    ksq = K[0] ** 2 + K[1] ** 2 + K[2] ** 2
    S = np.asarray(J.taylor_green_mhd())
    p = np.fft.rfftn(np.random.default_rng(seed).standard_normal((6,) + N),
                     axes=(1, 2, 3))
    for f in (p[:3], p[3:]):
        d = (K[0] * f[0] + K[1] * f[1] + K[2] * f[2]) / np.where(ksq == 0, 1,
                                                                ksq)
        f -= np.stack([K[0] * d, K[1] * d, K[2] * d])
    S = S + 0.05 * p / np.abs(p).max() * np.abs(S).max()
    return (S * np.asarray(J.FFT.get_dealias_filter())).astype(np.complex64)


@pytest.mark.parametrize("dealias", ["2/3-rule", "3/2-rule"])
def test_complex_steps_match_reference(dealias):
    Jf, Tf = _fft_pair()
    J, T = JMHD(Jf, dealias=dealias, **KW), TMHD(Tf, dealias=dealias, **KW)
    S = _state(J)
    sj, st = jnp.asarray(S), state_from_reference(S, Tf)
    for n in range(1, 4):
        sj, st = J.step(sj), T.step(st)
        if n in (1, 3):
            _close(st.numpy(), sj, STEP_TOL)
    if dealias == "2/3-rule":
        # (the 3/2 rule leaves the x/y-Nyquist modes of the k2 = 0 plane
        # unmasked, and i K breaks their Hermitian symmetry there: c2r
        # transforms read such a plane differently, so the energy of a
        # 3/2-rule state has no unique float64 value)
        for got, ref in zip(T.energies(st), _energies64(st.numpy())):
            assert abs(got - ref) <= 1e-5 * ref


def test_packed_steps_match_complex():
    Jf, Tf = _fft_pair()
    J = JMHD(Jf, dealias="2/3-rule", **KW)
    Tp = TMHD(Tf, dealias="2/3-rule", spectral_layout="packed", **KW)
    S = _state(J)
    sj = jnp.asarray(S)
    sp = Tp.to_packed(state_from_reference(S, Tf))
    assert sp.shape == (2, 6, N[0], N[1], N[2] // 2)
    pair = tuple(np.asarray(a) for a in J.to_packed(sj))
    _close(tuple(packed_state_from_reference(pair, Tf)), tuple(sp), 0.0)
    for got, ref in zip(Tp.energies(sp), _energies64(sj)):
        assert abs(got - ref) <= 1e-5 * ref
    for n in range(1, 4):
        sj, sp = J.step(sj), Tp.step(sp)
        if n in (1, 3):
            _close(Tp.from_packed(sp).numpy(), sj, STEP_TOL)


@pytest.mark.parametrize("layout", ["complex", "packed"])
def test_zero_field_reduces_to_ns(layout):
    """b = 0: the momentum is NS3D's and b stays 0 (2 RK4 steps)."""
    _, Tf = _fft_pair()
    ns = TNS(Tf, nu=KW["nu"], dt=KW["dt"], spectral_layout=layout)
    mh = TMHD(Tf, spectral_layout=layout, **KW)
    U = ns.taylor_green()
    ax = 1 if layout == "packed" else 0
    UB = torch.cat([U, 0 * U], dim=ax)
    for _ in range(2):
        U, UB = ns.step(U), mh.step(UB)
    u, b = (UB[:, :3], UB[:, 3:]) if layout == "packed" else (UB[:3], UB[3:])
    _close(u.numpy(), U.numpy(), 1e-6)
    assert float(b.abs().max()) == 0.0


@pytest.mark.parametrize("layout,precision,tol", [
    ("complex", "double", 1e-13), ("complex", "single", 1e-6),
    ("packed", "single", 1e-6)])
def test_induction_stays_solenoidal(layout, precision, tol):
    """∇·b of the Taylor–Green seed field stays at round-off over 3 RK4
    steps: max |K·b̂| against max |K|·max |b̂|."""
    _, Tf = _fft_pair(precision)
    s = TMHD(Tf, spectral_layout=layout, **KW)
    UB = s.taylor_green_mhd()
    e0 = sum(s.energies(UB))
    for _ in range(3):
        UB = s.step(UB)
    assert sum(s.energies(UB)) < e0
    b = UB[:, 3:] if layout == "packed" else UB[3:]
    kmax = max(float(k.abs().max()) for k in s._step_args()[:3])
    _, db = s.divergences(UB)
    assert db <= tol * kmax * float(b.abs().max())
