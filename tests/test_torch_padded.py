"""The port's 3/2-rule padded transform against the JAX package.

Kernels: the port's planar r2c/c2r (``rfft_last_planar``,
``irfft_last_planar``; on the CPU their plain twins) against the
reference's Pallas functions in interpret mode.  The reference pads the
spectral width to a multiple of 128 lanes: its first nf columns are
compared and the rest must be zero.  The slab: ``slab.R2C`` with
``dealias="3/2-rule"`` at N = (16, 16, 32), M = (24, 24, 48), against the
reference's XLA path and, in "single", its Pallas padded pipeline
(``MPIFFT4PY_TPU_PALLAS_DIST=force``, as tests/test_pallas_dist.py runs
it), and against the exact oracles of tests/test_slab.py and
tests/test_nyquist_alias.py.  The solver: ``NavierStokes3D`` with the 3/2
rule against the reference's from the same state.

Tolerances, relative to max |reference|: 1e-5 in float32 and 1e-12 in
float64 for the transforms; 2e-5 (float32) and 1e-11 (float64) for the
solver's state after 1 and 3 RK4 steps (FFTs through different libraries,
over up to 12 right-hand sides).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mpifft4py_tpu import slab as jslab
from mpifft4py_tpu.models.navier_stokes import NavierStokes3D as JNS
from mpifft4py_tpu.ops import pallas_fft3d as jp3
from mpifft4py_tpu_torch import state_from_reference
from mpifft4py_tpu_torch import slab as tslab
from mpifft4py_tpu_torch.models.navier_stokes import NavierStokes3D as TNS
from mpifft4py_tpu_torch.ops import fft3d as tp3
from test_torch_packed import _one_torch_thread  # noqa: F401
from test_nyquist_alias import _oracle_3d

TAU = 2 * np.pi
N = (16, 16, 32)
TOL = {"single": 1e-5, "double": 1e-12}
STEP_TOL = {"single": 2e-5, "double": 1e-11}
P3 = 1.5 ** 3


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, ref, tol=1e-5):
    got = [np.asarray(g) for g in (got if isinstance(got, tuple) else (got,))]
    ref = [np.asarray(r) for r in (ref if isinstance(ref, tuple) else (ref,))]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= tol * np.abs(r).max()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(precision, shape=N):
    L = np.array([TAU] * 3)
    return (jslab.R2C(np.array(shape), L, 1, precision),
            tslab.R2C(np.array(shape), L, None, precision, device="cpu"))


# -- the kernels --------------------------------------------------------------------

@pytest.mark.parametrize("n,nf,scale", [(48, None, 1.0), (48, 17, 1 / P3),
                                        (384, None, 1.0), (384, 129, 1 / P3),
                                        (384, 40, 2.0)])
def test_rfft_last_planar_matches_pallas(rng, n, nf, scale):
    x = _f32(rng, (3, 4, n))
    ref = jp3.rfft_last_planar(jnp.asarray(x), nf=nf, scale=scale)
    got = tp3.rfft_last_planar(_t(x), nf=nf, scale=scale)
    w = n // 2 + 1 if nf is None else nf
    assert got[0].shape == (3, 4, w)
    _close(got, tuple(np.asarray(r)[..., :w] for r in ref))
    assert not any(np.asarray(r)[..., w:].any() for r in ref)


@pytest.mark.parametrize("n,nf_in,scale", [(48, None, 1.0), (48, 17, P3),
                                           (384, None, 1.0), (384, 129, P3)])
def test_irfft_last_planar_matches_pallas(rng, n, nf_in, scale):
    w = n // 2 + 1 if nf_in is None else nf_in
    xr, xi = _f32(rng, (3, 4, w)), _f32(rng, (3, 4, w))
    nfp = -(-w // 128) * 128
    pad = [(0, 0), (0, 0), (0, nfp - w)]
    ref = jp3.irfft_last_planar(jnp.asarray(np.pad(xr, pad)),
                                jnp.asarray(np.pad(xi, pad)), n,
                                nf_in=nf_in, scale=scale)
    got = tp3.irfft_last_planar(_t(xr), _t(xi), n, nf_in=nf_in, scale=scale)
    _close(got, ref)


def test_planar_wrappers_reject_outside_envelope(rng):
    x = _t(_f32(rng, (4, 48)))
    with pytest.raises(ValueError):
        tp3.rfft_last_planar(_t(_f32(rng, (4, 2050))))        # above 2048
    with pytest.raises(ValueError):
        tp3.rfft_last_planar(x, nf=26)                        # > n//2 + 1
    y = _t(_f32(rng, (4, 17)))
    with pytest.raises(ValueError):
        tp3.irfft_last_planar(y, y, 48)                       # width 17 != 25
    with pytest.raises(TypeError):
        tp3.irfft_last_planar(y.double(), y.double(), 48, nf_in=17)


# -- the slab with the 3/2 rule ---------------------------------------------------

@pytest.mark.parametrize("precision,pallas", [("single", False),
                                              ("single", True),
                                              ("double", False)])
def test_padded_fftn_ifftn_match_reference(rng, monkeypatch, precision,
                                           pallas):
    if pallas:
        monkeypatch.setenv("MPIFFT4PY_TPU_PALLAS_DIST", "force")
    J, T = _pair(precision)
    assert J._pallas_dist_padded_ok() == pallas
    assert T._padded_kernel_ok() == (precision == "single")
    dt = np.float32 if precision == "single" else np.float64
    u = rng.standard_normal(T.work_shape("3/2-rule")).astype(dt)
    ft = T.fftn(u, dealias="3/2-rule")
    assert ft.shape == T.complex_shape() and ft.dtype == T.complex
    _close(ft.numpy(), J.fftn(u, dealias="3/2-rule"), TOL[precision])
    fu = np.fft.rfftn(rng.standard_normal(N)).astype(ft.numpy().dtype)
    _close(T.ifftn(fu, dealias="3/2-rule").numpy(),
           J.ifftn(fu, dealias="3/2-rule"), TOL[precision])


@pytest.mark.parametrize("precision", ["single", "double"])
def test_padded_fields_match_reference(rng, precision):
    J, T = _pair(precision)
    dt = np.float32 if precision == "single" else np.float64
    U = rng.standard_normal((3,) + T.work_shape("3/2-rule")).astype(dt)
    FU = T.forward_fields_fn("3/2-rule")(T.shard_real(U))
    fwd = jax.jit(J.forward_fields_fn("3/2-rule"))
    bwd = jax.jit(J.backward_fields_fn("3/2-rule"))
    _close(FU.numpy(), fwd(J.shard_real(U)), TOL[precision])
    _close(T.backward_fields_fn("3/2-rule")(FU).numpy(),
           bwd(J.shard_complex(FU.numpy())), TOL[precision])


@pytest.mark.parametrize("precision", ["single", "double"])
def test_padded_roundtrip_exact(rng, precision):
    """fftn(ifftn(fu, '3/2-rule'), '3/2-rule') == fu: the split-Nyquist
    pad and truncation are adjoint (tests/test_slab.py:83-94)."""
    _, T = _pair(precision)
    fu = T.fftn(T.shard_real(rng.standard_normal(N)))   # a Hermitian spectrum
    up = T.ifftn(fu, dealias="3/2-rule")
    assert tuple(up.shape) == T.global_real_shape_padded() == (24, 24, 48)
    fu2 = T.fftn(up, dealias="3/2-rule")
    _close(fu2.numpy(), fu.numpy(), 1e-6 if precision == "single" else 1e-13)


@pytest.mark.parametrize("precision", ["single", "double"])
def test_padded_physical_values(precision):
    """The padded inverse of a low-mode field is the analytic field sampled
    on the 1.5× grid (the padsize³ scaling; tests/test_slab.py:97-111)."""
    _, T = _pair(precision)
    X = [np.arange(n) * TAU / n for n in N]
    X = np.meshgrid(*X, indexing="ij")
    u = np.cos(3 * X[0]) * np.sin(2 * X[1]) * np.sin(X[2])
    up = T.ifftn(T.fftn(u), dealias="3/2-rule").numpy()
    Xm = np.meshgrid(*[np.arange(m) * TAU / m for m in T.M], indexing="ij")
    um = np.cos(3 * Xm[0]) * np.sin(2 * Xm[1]) * np.sin(Xm[2])
    assert np.abs(up - um).max() < (1e-6 if precision == "single" else 1e-12)


@pytest.mark.parametrize("precision", ["single", "double"])
def test_padded_forward_product_alias_exact(rng, precision):
    """The 3/2 forward of a product field against the exact alias-sum
    oracle (tests/test_nyquist_alias.py:19-57): the z-Nyquist plane must
    be the alias sum, not the doubled truncation."""
    _, T = _pair(precision, (16, 16, 16))
    u_M = T.ifftn(T.fftn(rng.standard_normal((16,) * 3)), dealias="3/2-rule")
    w_M = u_M * u_M
    got = T.fftn(w_M, dealias="3/2-rule").numpy()
    ref = _oracle_3d(w_M.numpy().astype(np.float64), 16, T.padsize)
    _close(got, ref, TOL[precision])


def test_dealias_options():
    _, T = _pair("single")
    assert T.work_shape("3/2-rule") == (24, 24, 48)
    with pytest.raises(ValueError):
        T.forward_fn("4/3-rule")
    # the packed interface keeps the reference's envelope: no 3/2 rule
    _, P = _pair("single", (16, 16, 256))
    with pytest.raises(ValueError, match="packed"):
        P.forward_packed_fn("3/2-rule")


# -- the slice: NS3D with the 3/2 rule -------------------------------------------------

def _solvers(precision, dealias="3/2-rule"):
    J, T = _pair(precision)
    kw = dict(nu=0.01, dt=0.01, dealias=dealias, integrator="RK4")
    return JNS(J, **kw), TNS(T, **kw)


def _state(J, seed=7):
    """Taylor–Green plus a seeded perturbation on every mode the N grid
    holds (the 3/2 rule dealiases the product, not the state)."""
    U = np.asarray(J.taylor_green())
    p = np.fft.rfftn(np.random.default_rng(seed).standard_normal((3,) + N),
                     axes=(1, 2, 3))
    return (U + 0.05 * p / np.abs(p).max() * np.abs(U).max()).astype(U.dtype)


@pytest.mark.parametrize("precision", ["single", "double"])
def test_padded_steps_match_reference(precision):
    J, T = _solvers(precision)
    assert T._bwd_nl is not T._bwd
    U = _state(J)
    sj, st = jnp.asarray(U), state_from_reference(U, T.FFT)
    _close(T.rhs_with_state(st).numpy(),
           jax.jit(J.rhs)(sj, *J._factored_k()), STEP_TOL[precision])
    for n in range(1, 4):
        sj, st = J.step(sj), T.step(st)
        if n in (1, 3):
            _close(st.numpy(), sj, STEP_TOL[precision])
    assert abs(T.energy(st) - J.energy(sj)) <= STEP_TOL[precision]


def test_padded_and_mask_dealias_stay_close():
    """Taylor–Green at t = 0 has only low modes: no aliasing yet, so the
    3/2 and 2/3 rules nearly agree after a step
    (tests/test_navier_stokes.py:118)."""
    _, t32 = _solvers("double")
    _, t23 = _solvers("double", "2/3-rule")
    assert t23._bwd_nl is t23._bwd
    U32 = t32.step(t32.taylor_green())
    U23 = t23.step(t23.taylor_green())
    assert np.allclose(U32.numpy(), U23.numpy(), atol=1e-8)
    assert t32.energy(U32) < 0.125


def test_packed_layout_refuses_the_padded_rule():
    L = np.array([TAU] * 3)
    kw = dict(nu=0.01, dt=0.01, dealias="3/2-rule", spectral_layout="packed")
    with pytest.raises(ValueError, match="packed"):
        TNS(tslab.R2C(np.array((16, 16, 256)), L, None, "single",
                      device="cpu"), **kw)
