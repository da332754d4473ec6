"""The port's VorticityVelocity3D and its kernel variants against the JAX
package.

Kernels: ``curl_irfft3d_packed(biot_savart=True)`` (with and without the
state) and ``fft_x_epilogue_packed`` in mode "curl" (on the CPU, their plain
twins through the same glue) against the reference's Pallas functions in
interpret mode, at 1e-5 of max |reference|.  The solver: the port's complex
step under the 2/3 and the 3/2 rule, and its packed step, against the
reference's jitted complex step from the same state, after 1 and 3 RK4
steps, at 2e-5 of max |reference| (float32 FFTs through different
libraries, over up to 12 right-hand sides); the reference's packed step is
not run (minutes in interpret mode).  Oracles in the port: VV is the curl
of NS3D, in both layouts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mpifft4py_tpu import slab as jslab
from mpifft4py_tpu.models.vv import VorticityVelocity3D as JVV
from mpifft4py_tpu.ops import pallas_fft3d as jp3
from mpifft4py_tpu_torch import state_from_reference
from mpifft4py_tpu_torch import slab as tslab
from mpifft4py_tpu_torch.models import NavierStokes3D as TNS
from mpifft4py_tpu_torch.models import VorticityVelocity3D as TVV
from mpifft4py_tpu_torch.ops import fft3d as tp3
from test_torch_packed import _close, _f32, _kvecs, _masks, _t

TAU = 2 * np.pi
STEP_TOL = 2e-5
N = (16, 16, 256)
KW = dict(nu=0.01, dt=0.01, integrator="RK4")


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


# -- the kernels --------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [True, False])
def test_curl_irfft3d_packed_biot_savart_matches_pallas(rng, with_state):
    """Pass 0 (the velocity) takes 1/|K|², pass 1 (the state) does not."""
    s, pk = (16, 16, 256), (3, 16, 16, 128)
    ur, ui = _f32(rng, pk), _f32(rng, pk)
    ks = _kvecs(pk[1:])
    ref = jp3.curl_irfft3d_packed(jnp.asarray(ur), jnp.asarray(ui),
                                  *map(jnp.asarray, ks), s, biot_savart=True,
                                  with_state=with_state)
    got = tp3.curl_irfft3d_packed(_t(ur), _t(ui), *map(_t, ks), s,
                                  biot_savart=True, with_state=with_state)
    _close(got, ref)


def test_fft_x_epilogue_curl_matches_pallas(rng):
    pk = (3, 16, 16, 128)
    fr, fi, sr, si = (_f32(rng, pk) for _ in range(4))
    args = (fr, fi, sr, si) + _kvecs(pk[1:]) + _masks(pk[1:])
    ref = jp3.fft_x_epilogue_packed(*map(jnp.asarray, args), "curl", 0.01)
    got = tp3.fft_x_epilogue_packed(*map(_t, args), "curl", 0.01)
    assert got.shape == (2,) + pk
    _close(tuple(got), ref)


# -- the solver ---------------------------------------------------------------------

def _fft_pair(precision="single"):
    L = np.array([TAU] * 3)
    return (jslab.R2C(np.array(N), L, 1, precision),
            tslab.R2C(np.array(N), L, None, precision, device="cpu"))


def _energy64(V_hat, K=None):
    """0.5 <|v|²> in float64 of a complex spectral 3-stack (of the
    Biot–Savart velocity i K × V̂/|K|² when K is given): the oracle of the
    energy diagnostics (the reference's float32 reductions on XLA:CPU are
    ~2e-5 off it at this size)."""
    V = np.asarray(V_hat).astype(np.complex128)
    if K is not None:
        ksq = K[0] ** 2 + K[1] ** 2 + K[2] ** 2
        V = 1j * np.stack([K[1] * V[2] - K[2] * V[1], K[2] * V[0] - K[0] * V[2],
                           K[0] * V[1] - K[1] * V[0]]) / np.where(ksq == 0, 1,
                                                                  ksq)
    v = np.fft.irfftn(V, s=N, axes=(1, 2, 3))
    return 0.5 * np.mean(np.sum(v * v, axis=0))


def _k(J):
    k0, k1, k2 = (np.asarray(k, np.float64) for k in J._complex_k_args())
    return k0[:, None, None], k1[None, :, None], k2[None, None, :]


def _state(J, seed=7):
    """The curl of Taylor–Green plus a seeded velocity perturbation,
    2/3-rule masked (so the packed pair holds no Nyquist rider), as
    complex64 numpy."""
    K = _k(J)
    W = np.asarray(J.taylor_green())
    p = np.fft.rfftn(np.random.default_rng(seed).standard_normal((3,) + N),
                     axes=(1, 2, 3))
    p = 1j * np.stack([K[1] * p[2] - K[2] * p[1], K[2] * p[0] - K[0] * p[2],
                       K[0] * p[1] - K[1] * p[0]])
    W = W + 0.05 * p / np.abs(p).max() * np.abs(W).max()
    return (W * np.asarray(J.FFT.get_dealias_filter())).astype(np.complex64)


@pytest.mark.parametrize("dealias", ["2/3-rule", "3/2-rule"])
def test_complex_steps_match_reference(dealias):
    Jf, Tf = _fft_pair()
    J, T = JVV(Jf, dealias=dealias, **KW), TVV(Tf, dealias=dealias, **KW)
    W = _state(J)
    sj, st = jnp.asarray(W), state_from_reference(W, Tf)
    _close(T.velocity(st).numpy(), J.velocity(sj))
    for n in range(1, 4):
        sj, st = J.step(sj), T.step(st)
        if n in (1, 3):
            _close(st.numpy(), sj, STEP_TOL)
    if dealias == "2/3-rule":      # (see tests/test_torch_mhd.py)
        e, z = _energy64(st.numpy(), _k(J)), _energy64(st.numpy())
        assert abs(T.energy(st) - e) <= 1e-5 * e
        assert abs(T.enstrophy(st) - z) <= 1e-5 * z


def test_packed_steps_match_complex():
    Jf, Tf = _fft_pair()
    J = JVV(Jf, dealias="2/3-rule", **KW)
    Tp = TVV(Tf, dealias="2/3-rule", spectral_layout="packed", **KW)
    W = _state(J)
    sj = jnp.asarray(W)
    sp = Tp.to_packed(state_from_reference(W, Tf))
    assert sp.shape == (2, 3, N[0], N[1], N[2] // 2)
    e, z = _energy64(sj, _k(J)), _energy64(sj)
    assert abs(Tp.energy(sp) - e) <= 1e-5 * e
    assert abs(Tp.enstrophy(sp) - z) <= 1e-5 * z
    for n in range(1, 4):
        sj, sp = J.step(sj), Tp.step(sp)
        if n in (1, 3):
            _close(Tp.from_packed(sp).numpy(), sj, STEP_TOL)


def test_taylor_green_and_velocity():
    _, Tf = _fft_pair()
    c = TVV(Tf, **KW)
    p = TVV(Tf, spectral_layout="packed", **KW)
    Wc, Wp = c.taylor_green(), p.taylor_green()
    _close(p.from_packed(Wp).numpy(), Wc.numpy())
    U = TNS(Tf, **KW).taylor_green()
    _close(c.velocity(c.from_velocity(U)).numpy(), U.numpy())
    for s, W in ((c, Wc), (p, Wp)):
        assert abs(s.energy(W) - 0.125) < 1e-6
        assert abs(s.enstrophy(W) - 0.375) < 1e-6


@pytest.mark.parametrize("layout", ["complex", "packed"])
def test_vv_is_the_curl_of_ns(layout):
    """In exact arithmetic curl(NS trajectory) == VV trajectory: both
    solvers of the port, 2 RK4 steps from Taylor–Green (float64 for the
    complex layout, float32 for the packed)."""
    precision = "double" if layout == "complex" else "single"
    _, Tf = _fft_pair(precision)
    kw = dict(KW, spectral_layout=layout)
    ns, vv = TNS(Tf, **kw), TVV(Tf, **kw)
    U, W = ns.taylor_green(), vv.taylor_green()
    for _ in range(2):
        U, W = ns.step(U), vv.step(W)
    if layout == "packed":
        U, W = ns.from_packed(U), vv.from_packed(W)
    ref = vv.from_velocity(U).numpy()
    tol = 1e-10 if precision == "double" else 2e-6
    _close(W.numpy(), ref, tol)
