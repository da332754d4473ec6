"""The port's packed spectral layout against the JAX package.

Kernels: the port's fused NS3D kernel functions (on the CPU, their plain
twins through the same glue) against the reference's Pallas functions in
interpret mode, at 1e-5 of max |reference|.  The interface: the packed
forward/backward against the reference's under
``MPIFFT4PY_TPU_PALLAS_DIST=force``, as tests/test_packed_layout.py runs it.
The slice: the port's packed step against the reference's complex-layout
step (XLA; the reference's own oracle for its packed step,
tests/test_packed_layout.py:77-94) and the port's complex-layout step,
after 1 and 3 steps, at 2e-5 of max |reference| (float32 FFTs through
different libraries, over up to 12 right-hand sides).  The reference's
packed step itself is not run: in interpret mode it takes minutes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mpifft4py_tpu import slab as jslab
from mpifft4py_tpu.models import diagnostics as jdiag
from mpifft4py_tpu.models.navier_stokes import NavierStokes3D as JNS
from mpifft4py_tpu.ops import pallas_fft3d as jp3
from mpifft4py_tpu_torch import (packed_state_from_reference,
                                 state_from_reference)
from mpifft4py_tpu_torch import slab as tslab
from mpifft4py_tpu_torch.models import diagnostics as tdiag
from mpifft4py_tpu_torch.models.navier_stokes import NavierStokes3D as TNS
from mpifft4py_tpu_torch.ops import fft3d as tp3

TAU = 2 * np.pi
RTOL = 1e-5
STEP_TOL = 2e-5
N = (16, 32, 256)
CASES = [("RK4", None), ("LSRK54", None), ("Euler", None), ("AB2", None),
         ("RK4", (1.0, 3.0))]


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture
def force_dist(monkeypatch):
    """The reference's packed interface off the TPU, as
    tests/test_packed_layout.py enables it."""
    monkeypatch.setenv("MPIFFT4PY_TPU_PALLAS_DIST", "force")


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, ref, rtol=RTOL):
    got = [np.asarray(g) for g in (got if isinstance(got, tuple) else (got,))]
    ref = [np.asarray(r) for r in (ref if isinstance(ref, tuple) else (ref,))]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= rtol * np.abs(r).max()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _kvecs(shape, scale=(1.0, 0.5, 2.0)):
    """1-D wavenumbers of a packed (N0, N1, h) layout, scaled per axis."""
    n0, n1, h = shape
    return (np.fft.fftfreq(n0, 1 / n0).astype(np.float32) * scale[0],
            np.fft.fftfreq(n1, 1 / n1).astype(np.float32) * scale[1],
            np.arange(h, dtype=np.float32) * scale[2])


def _masks(shape):
    """1-D 2/3-rule masks of a packed (N0, N1, h) layout."""
    return tuple(np.abs(k) < 2 / 3 * (n // 2) for k, n in
                 zip(_kvecs(shape, (1, 1, 1)),
                     (shape[0], shape[1], 2 * shape[2])))


# -- the kernels ------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [True, False])
def test_curl_irfft3d_packed_matches_pallas(rng, with_state):
    s = (16, 16, 256)
    pk = (3, 16, 16, 128)
    ur, ui = _f32(rng, pk), _f32(rng, pk)
    ks = _kvecs(pk[1:])
    ref = jp3.curl_irfft3d_packed(jnp.asarray(ur), jnp.asarray(ui),
                                  *map(jnp.asarray, ks), s,
                                  with_state=with_state)
    got = tp3.curl_irfft3d_packed(_t(ur), _t(ui), *map(_t, ks), s,
                                  with_state=with_state)
    _close(got, ref)


def test_cross_rfft_zy_packed_matches_pallas(rng):
    a, b = _f32(rng, (3, 1, 64, 256)), _f32(rng, (3, 1, 64, 256))
    assert jp3._cross_zy_oneshot_ok(64, 256)       # the one-shot kernel
    _close(tp3.cross_rfft_zy_packed(_t(a), _t(b)),
           jp3.cross_rfft_zy_packed(jnp.asarray(a), jnp.asarray(b)))


def test_cross_rfft_zy_packed_512_plane_matches_acc(rng):
    """Row 13's function: the reference's z-tiled kernel for 512-class
    planes; the port's cross kernel serves it unchanged."""
    a, b = _f32(rng, (3, 1, 512, 512)), _f32(rng, (3, 1, 512, 512))
    assert not jp3._cross_zy_oneshot_ok(512, 512)
    _close(tp3.cross_rfft_zy_packed(_t(a), _t(b)),
           jp3._cross_rfft_zy_acc([jnp.asarray(a), jnp.asarray(b)], "cross",
                                  dif=False))


def test_fft_x_epilogue_packed_matches_pallas(rng):
    pk = (3, 16, 16, 128)
    fr, fi, sr, si = (_f32(rng, pk) for _ in range(4))
    ks = _kvecs(pk[1:])
    ms = _masks(pk[1:])
    ref = jp3.fft_x_epilogue_packed(*map(jnp.asarray, (fr, fi, sr, si) + ks
                                         + ms), "project", 0.01)
    got = tp3.fft_x_epilogue_packed(*map(_t, (fr, fi, sr, si) + ks + ms),
                                    "project", 0.01)
    assert got.shape == (2,) + pk
    _close(tuple(got), ref)


def test_purify_plane0_dus_matches_reference(rng):
    yr, yi = _f32(rng, (3, 8, 6, 5)), _f32(rng, (3, 8, 6, 5))
    ref = jp3.purify_plane0_dus(jnp.asarray(yr), jnp.asarray(yi))
    tr, ti = _t(yr.copy()), _t(yi.copy())
    got = tp3.purify_plane0_dus(tr, ti)
    assert got[0] is tr and got[1] is ti          # updated in place
    _close(got, ref)
    assert np.array_equal(tr.numpy()[..., 1:], yr[..., 1:])


def test_off_path_variants_raise(rng):
    """Every variant of the fused kernels is ported; what stays refused is
    outside their envelope: wrong vectors, an unknown mode, the buoyancy
    rider outside mode "project", a state or rider of the wrong
    component count, cross2 without its fourth stack, a mul field that is
    not one component."""
    x = _t(_f32(rng, (3, 16, 16, 128)))
    k = tuple(map(_t, _kvecs((16, 16, 128))))
    m = tuple(torch.ones_like(v, dtype=torch.bool) for v in k)
    with pytest.raises(ValueError):
        tp3.curl_irfft3d_packed(x, x, k[1], k[0][:8], k[2], (16, 8, 256))
    with pytest.raises(ValueError):
        tp3.curl_irfft3d_packed(x, x, k[1], k[0][:8], k[2], (16, 8, 256),
                                biot_savart=True, with_state=True)
    a = _t(_f32(rng, (3, 2, 16, 256)))
    with pytest.raises(ValueError, match="cross2"):
        tp3.cross_rfft_zy_packed(a, a, a)
    with pytest.raises(ValueError):
        tp3.cross_rfft_zy_packed(a, a, a, a[:, :1])
    with pytest.raises(ValueError):
        tp3.mul_rfft_zy_packed(a, a[:2])
    with pytest.raises(ValueError, match="mode"):
        tp3.fft_x_epilogue_packed(x, x, x, x, *k, *m, "grad", 0.01)
    for mode in ("curl", "div"):
        with pytest.raises(ValueError, match="buoyancy"):
            tp3.fft_x_epilogue_packed(x, x, x[:1] if mode == "div" else x,
                                      x[:1] if mode == "div" else x, *k, *m,
                                      mode, 0.01, buoy=(x[:1], x[:1], 0.5))
    with pytest.raises(ValueError, match="state"):
        tp3.fft_x_epilogue_packed(x, x, x, x, *k, *m, "div", 0.01)
    with pytest.raises(ValueError, match="state"):
        tp3.fft_x_epilogue_packed(x, x, x[:1], x[:1], *k, *m, "curl", 0.01)
    with pytest.raises(ValueError, match="rider"):
        tp3.fft_x_epilogue_packed(x, x, x, x, *k, *m, "project", 0.01,
                                  buoy=(x, x, 0.5))
    with pytest.raises(ValueError, match="out"):
        tp3.fft_x_epilogue_packed(x, x, x, x, *k, *m, "project", 0.01,
                                  out=torch.empty((2, 1, 16, 16, 128)))


def test_gates_are_shape_predicates():
    assert tp3.curl_fused_ok(256) and tp3.fft_x_epilogue_ok(1024)
    assert not tp3.curl_fused_ok(8) and not tp3.fft_x_epilogue_ok(2048)
    assert tp3.cross_zy_ok(512, 512) and tp3.cross_zy_ok(256, 256)
    assert not tp3.cross_zy_ok(20, 256) and not tp3.cross_zy_ok(64, 2048)


# -- the packed interface -----------------------------------------------------------

def test_packed_interface_matches_reference(rng, force_dist):
    shape = (16, 16, 256)
    L = np.array([TAU] * 3)
    J = jslab.R2C(np.array(shape), L, 1, "single")
    T = tslab.R2C(np.array(shape), L, None, "single", device="cpu")
    assert T.packed_z_perm is None and T._packed_iface_ok("2/3-rule")
    u = _f32(rng, (3,) + shape)
    ref = jax.jit(J.forward_packed_fn("2/3-rule"))(jnp.asarray(u))
    got = T.forward_packed_fn("2/3-rule")(_t(u))
    _close(got, ref)
    _close(T.backward_packed_fn()(got),
           J.backward_packed_fn()(tuple(map(jnp.asarray, ref))))


@pytest.mark.parametrize("shape,precision,dealias", [
    ((16, 16, 64), "single", "2/3-rule"),
    ((16, 16, 256), "double", "2/3-rule"),
    ((16, 16, 256), "single", None)])
def test_packed_envelope_matches_reference(force_dist, shape, precision,
                                           dealias):
    L = np.array([TAU] * 3)
    kw = dict(nu=0.01, dt=0.001, dealias=dealias, spectral_layout="packed")
    with pytest.raises(ValueError, match="packed"):
        JNS(jslab.R2C(np.array(shape), L, 1, precision), **kw)
    with pytest.raises(ValueError, match="packed"):
        TNS(tslab.R2C(np.array(shape), L, None, precision, device="cpu"),
            **kw)


# -- the slice: the packed NS3D step -------------------------------------------------

def _solvers(integrator="RK4", forcing=None):
    L = np.array([TAU] * 3)
    kw = dict(nu=0.01, dt=0.01, dealias="2/3-rule", integrator=integrator)
    if forcing is not None:
        kw.update(forcing_band=forcing, forcing_rate=0.1)
    J = JNS(jslab.R2C(np.array(N), L, 1, "single"), **kw)
    FFT = tslab.R2C(np.array(N), L, None, "single", device="cpu")
    return J, TNS(FFT, **kw), TNS(FFT, spectral_layout="packed", **kw)


def _state(J, seed=7):
    """Taylor–Green plus a seeded perturbation, 2/3-rule masked (so the
    packed pair holds no Nyquist rider), complex64 numpy."""
    U = np.asarray(J.taylor_green())
    rng = np.random.default_rng(seed)
    p = np.fft.rfftn(rng.standard_normal((3,) + N), axes=(1, 2, 3))
    U = U + 0.05 * p / np.abs(p).max() * np.abs(U).max()
    return (U * np.asarray(J.FFT.get_dealias_filter())).astype(np.complex64)


@pytest.mark.parametrize("integrator,forcing", CASES)
def test_packed_steps_match_complex(integrator, forcing):
    J, Tc, Tp = _solvers(integrator, forcing)
    U = _state(J)
    sj = jnp.asarray(U)
    sc = state_from_reference(U, Tc.FFT)
    sp = Tp.to_packed(sc)
    assert sp.shape == (2, 3, N[0], N[1], N[2] // 2)
    if integrator == "AB2":
        sj, sc, sp = J.ab2_state(sj), Tc.ab2_state(sc), Tp.ab2_state(sp)
    for n in range(1, 4):
        sj, sc, sp = J.step(sj), Tc.step(sc), Tp.step(sp)
        if n in (1, 3):
            got = Tp.from_packed(Tp._carry_state(sp)).numpy()
            _close(got, J._carry_state(sj), STEP_TOL)
            _close(got, Tc._carry_state(sc).numpy(), STEP_TOL)


@pytest.mark.parametrize("layout", ["complex", "packed"])
def test_step_args_match_reference(layout):
    """The factored wavenumbers (and the packed layout's 2/3-rule masks)
    the right-hand side takes, against the reference's, exactly."""
    L = np.array([2.0, TAU, 3.0])
    J = jslab.R2C(np.array(N), L, 1, "single")
    T = tslab.R2C(np.array(N), L, None, "single", device="cpu")
    kw = dict(nu=0.01, dt=0.01, dealias="2/3-rule")
    J, S = JNS(J, **kw), TNS(T, spectral_layout=layout, **kw)
    ref = J._packed_arrays() if layout == "packed" else J._factored_k()
    got = S._step_args()
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == (torch.bool if r.dtype == jnp.bool_
                           else torch.float32)
        assert np.array_equal(g.numpy(), np.asarray(r))


def test_packed_run_monitor_matches_steps():
    J, _, Tp = _solvers()
    U0 = Tp.to_packed(state_from_reference(_state(J), Tp.FFT))
    U, trace = Tp.run(U0, 2, monitor_every=1)
    assert trace.shape == (2,) and float(trace[1]) < float(trace[0])
    assert abs(float(trace[-1]) - Tp.energy(U)) < 1e-9


def test_packed_diagnostics_match_reference():
    J, Tc, Tp = _solvers()
    assert torch.equal(Tp.taylor_green(), Tp.to_packed(Tc.taylor_green()))
    ref = J.to_packed(jnp.asarray(_state(J)))
    pair = tuple(np.asarray(a) for a in ref)
    S = packed_state_from_reference(pair, Tp.FFT)
    assert S.shape == (2, 3, N[0], N[1], N[2] // 2)
    _close(tuple(S), pair, 0.0)
    assert abs(Tp.energy(S) - J.energy_packed(ref)) <= RTOL * 0.125
    _close(tdiag.energy_spectrum_packed(Tp.FFT, S),
           jdiag.energy_spectrum_packed(J.FFT, ref))
    eps_t = tdiag.dissipation_packed(Tp.FFT, S, 0.01)
    eps_j = jdiag.dissipation_packed(J.FFT, ref, 0.01)
    assert abs(eps_t - eps_j) <= RTOL * abs(eps_j)
    # the packed diagnostics and RHS agree with the complex ones
    Uc = Tp.from_packed(S)
    _close(tdiag.energy_spectrum_packed(Tp.FFT, S),
           tdiag.energy_spectrum(Tp.FFT, Uc))
    _close(Tp.from_packed(Tp.rhs_with_state(S)).numpy(),
           Tc.rhs_with_state(Uc).numpy(), STEP_TOL)


def test_packed_state_from_reference_checks_shape_and_dtype():
    _, _, Tp = _solvers()
    pair = (np.zeros((3, 16, 32, 128), np.float32),) * 2
    assert packed_state_from_reference(pair, Tp.FFT).dtype == torch.float32
    with pytest.raises(TypeError):
        packed_state_from_reference(tuple(a.astype(np.float64) for a in pair),
                                    Tp.FFT)
    with pytest.raises(ValueError):
        packed_state_from_reference(tuple(a[..., :-1] for a in pair), Tp.FFT)
