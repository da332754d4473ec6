"""The port's Boussinesq3D and its kernel variants against the JAX package.

Kernels: ``mul_rfft_zy_packed`` (row 15; also at a 512-class plane against
the reference's z-tiled ``_cross_rfft_zy_acc(..., "mul")``, row 13's
function), the z-only ``mul_rfft_z`` (row 16's ``mul_rfft_z_packed``,
``dif=False``) and ``fft_x_epilogue_packed`` in mode "div" and in mode
"project" with the buoyancy rider, against the reference's Pallas functions
in interpret mode at 1e-5 of max |reference|.  The solver: the port's
complex step under the 2/3 and the 3/2 rule, and its packed step, against
the reference's jitted complex step from the same 4-component state, after
1 and 3 RK4 steps, at 2e-5 of max |reference|.  Oracles in the port: with
Ri = 0 the velocity is NS3D's; the rest state stays at rest while θ
diffuses.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mpifft4py_tpu import slab as jslab
from mpifft4py_tpu.models.boussinesq import Boussinesq3D as JBQ
from mpifft4py_tpu.ops import pallas_fft3d as jp3
from mpifft4py_tpu_torch import state_from_reference
from mpifft4py_tpu_torch import slab as tslab
from mpifft4py_tpu_torch.models import Boussinesq3D as TBQ
from mpifft4py_tpu_torch.models import NavierStokes3D as TNS
from mpifft4py_tpu_torch.ops import fft3d as tp3
from test_torch_packed import (_close, _f32, _kvecs,  # noqa: F401
                               _masks, _one_torch_thread, _t)

TAU = 2 * np.pi
STEP_TOL = 2e-5
N = (16, 16, 256)       # the packed gate needs (N2/2) % 128 == 0
NC = (16, 16, 32)       # the complex layout needs no such width
KW = dict(nu=0.01, kappa=0.02, dt=0.01, Ri=0.7, integrator="RK4")


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


# -- the kernels --------------------------------------------------------------------

def test_mul_rfft_zy_packed_matches_pallas(rng):
    a, t = _f32(rng, (3, 1, 64, 256)), _f32(rng, (1, 1, 64, 256))
    assert jp3._cross_zy_oneshot_ok(64, 256)           # the one-shot kernel
    _close(tp3.mul_rfft_zy_packed(_t(a), _t(t)),
           jp3.mul_rfft_zy_packed(jnp.asarray(a), jnp.asarray(t)))


def test_mul_rfft_zy_packed_512_plane_matches_acc(rng):
    """The reference's z-tiled kernel for 512-class planes, op "mul"."""
    a, t = _f32(rng, (3, 1, 512, 512)), _f32(rng, (1, 1, 512, 512))
    assert not jp3._cross_zy_oneshot_ok(512, 512)
    _close(tp3.mul_rfft_zy_packed(_t(a), _t(t)),
           jp3._cross_rfft_zy_acc([jnp.asarray(a), jnp.asarray(t)], "mul",
                                  dif=False))


def test_mul_rfft_z_matches_z_only_pallas(rng):
    """Row 16's scalar-flux function (no y stage) is the port's mul load."""
    a, t = _f32(rng, (3, 4, 16, 256)), _f32(rng, (1, 4, 16, 256))
    _close(tp3.mul_rfft_z(_t(a), _t(t)),
           jp3.mul_rfft_z_packed(jnp.asarray(a), jnp.asarray(t), dif=False))


def test_fft_x_epilogue_div_matches_pallas(rng):
    pk = (3, 16, 16, 128)
    fr, fi = _f32(rng, pk), _f32(rng, pk)
    sr, si = _f32(rng, (1,) + pk[1:]), _f32(rng, (1,) + pk[1:])
    args = (fr, fi, sr, si) + _kvecs(pk[1:]) + _masks(pk[1:])
    ref = jp3.fft_x_epilogue_packed(*map(jnp.asarray, args), "div", 0.01)
    got = tp3.fft_x_epilogue_packed(*map(_t, args), "div", 0.01)
    assert got.shape == (2, 1) + pk[1:]
    _close(tuple(got), ref)


def test_fft_x_epilogue_buoyancy_matches_pallas(rng):
    """The rider joins after the mask: θ̂ is random on every mode, so a
    masked rider would differ."""
    pk = (3, 16, 16, 128)
    fr, fi, sr, si = (_f32(rng, pk) for _ in range(4))
    tr, ti = _f32(rng, (1,) + pk[1:]), _f32(rng, (1,) + pk[1:])
    args = (fr, fi, sr, si) + _kvecs(pk[1:]) + _masks(pk[1:])
    assert jp3.fft_x_epilogue_ok(16, buoy=True)        # the rider kernel
    ref = jp3.fft_x_epilogue_packed(*map(jnp.asarray, args), "project", 0.01,
                                    buoy=(jnp.asarray(tr), jnp.asarray(ti),
                                          0.7))
    got = tp3.fft_x_epilogue_packed(*map(_t, args), "project", 0.01,
                                    buoy=(_t(tr), _t(ti), 0.7))
    _close(tuple(got), ref)


# -- the solver ---------------------------------------------------------------------

def _grid(J):
    return tuple(int(n) for n in J.FFT.N)


def _physical(S):
    """The physical grid of a complex spectral stack (C, N0, N1, Nf)."""
    return (S.shape[1], S.shape[2], 2 * (S.shape[3] - 1))


def _fft_pair(precision="single", shape=N):
    L = np.array([TAU] * 3)
    return (jslab.R2C(np.array(shape), L, 1, precision),
            tslab.R2C(np.array(shape), L, None, precision, device="cpu"))


def _state(J, seed=7):
    """The reference's stratified Taylor–Green state plus a seeded
    perturbation (solenoidal in the velocity), 2/3-rule masked, complex64
    numpy."""
    k0, k1, k2 = (np.asarray(k, np.float64) for k in J._complex_k_args())
    K = (k0[:, None, None], k1[None, :, None], k2[None, None, :])
    ksq = K[0] ** 2 + K[1] ** 2 + K[2] ** 2
    S = np.asarray(J.taylor_green_stratified())
    noise = np.random.default_rng(seed).standard_normal((4,) + _grid(J))
    p = np.fft.rfftn(noise, axes=(1, 2, 3))
    d = (K[0] * p[0] + K[1] * p[1] + K[2] * p[2]) / np.where(ksq == 0, 1, ksq)
    p[:3] -= np.stack([K[0] * d, K[1] * d, K[2] * d])
    S = S + 0.05 * p / np.abs(p).max() * np.abs(S).max()
    return (S * np.asarray(J.FFT.get_dealias_filter())).astype(np.complex64)


def _energies64(S):
    s = np.fft.irfftn(np.asarray(S).astype(np.complex128), s=_physical(S),
                      axes=(1, 2, 3))
    return (0.5 * np.mean(np.sum(s[:3] ** 2, axis=0)),
            0.5 * np.mean(s[3] ** 2))


@pytest.mark.parametrize("dealias", ["2/3-rule", "3/2-rule"])
def test_complex_steps_match_reference(dealias):
    Jf, Tf = _fft_pair(shape=NC)
    J, T = JBQ(Jf, dealias=dealias, **KW), TBQ(Tf, dealias=dealias, **KW)
    S = _state(J)
    sj, st = jnp.asarray(S), state_from_reference(S, Tf)
    for n in range(1, 4):
        sj, st = J.step(sj), T.step(st)
        if n in (1, 3):
            _close(st.numpy(), sj, STEP_TOL)
    if dealias == "2/3-rule":      # (see tests/test_torch_mhd.py)
        for got, ref in zip(T.energies(st), _energies64(st.numpy())):
            assert abs(got - ref) <= 1e-5 * ref


def test_packed_steps_match_complex():
    Jf, Tf = _fft_pair()
    J = JBQ(Jf, dealias="2/3-rule", **KW)
    Tp = TBQ(Tf, dealias="2/3-rule", spectral_layout="packed", **KW)
    S = _state(J)
    sj = jnp.asarray(S)
    sp = Tp.to_packed(state_from_reference(S, Tf))
    assert sp.shape == (2, 4, N[0], N[1], N[2] // 2)
    for got, ref in zip(Tp.energies(sp), _energies64(S)):
        assert abs(got - ref) <= 1e-5 * ref
    for n in range(1, 4):
        sj, sp = J.step(sj), Tp.step(sp)
        if n in (1, 3):
            _close(Tp.from_packed(sp).numpy(), sj, STEP_TOL)


def test_initial_states_match_reference():
    Jf, Tf = _fft_pair()
    J = JBQ(Jf, **KW)
    c, p = TBQ(Tf, **KW), TBQ(Tf, spectral_layout="packed", **KW)
    for make in ("taylor_green_stratified", "rest_state"):
        ref = np.asarray(getattr(J, make)())
        _close(getattr(c, make)().numpy(), ref, 1e-6)
        _close(p.from_packed(getattr(p, make)()).numpy(), ref, 1e-6)


@pytest.mark.parametrize("layout", ["complex", "packed"])
def test_ri_zero_velocity_matches_ns(layout):
    """Ri = 0 decouples θ: the velocity evolves as NS3D's (2 RK4 steps)."""
    _, Tf = _fft_pair(shape=NC if layout == "complex" else N)
    ns = TNS(Tf, nu=KW["nu"], dt=KW["dt"], spectral_layout=layout)
    bq = TBQ(Tf, spectral_layout=layout, **dict(KW, Ri=0.0))
    U = ns.taylor_green()
    S = bq.taylor_green_stratified()
    u = S[:, :3] if layout == "packed" else S[:3]
    _close(u.numpy(), U.numpy(), 0.0)
    for _ in range(2):
        U, S = ns.step(U), bq.step(S)
    u = S[:, :3] if layout == "packed" else S[:3]
    _close(u.numpy(), U.numpy(), 1e-6)


@pytest.mark.parametrize("layout,precision,tol", [
    ("complex", "double", 1e-12), ("packed", "single", 1e-6)])
def test_rest_state_stays_at_rest(layout, precision, tol):
    """u = 0, θ = θ0 sin(z): the buoyancy is a pure gradient, the
    projection removes it, and θ decays by diffusion alone (its variance
    by e^{−2κt})."""
    _, Tf = _fft_pair(precision, NC if layout == "complex" else N)
    s = TBQ(Tf, spectral_layout=layout, **KW)
    S = s.rest_state()
    eu0, et0 = s.energies(S)
    assert eu0 == 0.0
    for _ in range(3):
        S = s.step(S)
    eu, et = s.energies(S)
    assert eu < 1e-20
    assert abs(et - et0 * np.exp(-2 * s.kappa * 3 * s.dt)) <= tol * et0
