"""The port's kernel envelope against the JAX package's.

The predicates: ``supported_c2c``/``supported_r2c`` (and ``_factor``) equal
the reference's for every n in 1..2048, and the fused kernels' gates are
those predicates.  The packed 3D layout at one small grid of each kind the
widened kernels serve: (26, 40, 256) (13 and 5 are prime factors: a direct
13-point stage and a radix-5 stage), (16, 24, 1280) (the half-length z of
h = 640 = 2^7·5) and (16, 16, 2048) (h = 1024, above the old 1024-point
r2c bound):

* the packed interface (``forward_packed_fn``/``backward_packed_fn``) of
  one field against the reference's under
  ``MPIFFT4PY_TPU_PALLAS_DIST=force`` (Pallas in interpret mode, as
  tests/test_packed_layout.py runs it), at 1e-5 of max |reference|.  One
  field, not a 3-stack: the reference's z kernel leaves rows unwritten
  where its row count is not a multiple of its 128-row tile and too large
  for one block (``pallas_fft3d._pick_tr``; a 3-stack at (26, 40, 256) is
  3120 rows, and its last 48 come out NaN in interpret mode), a defect
  recorded in ROADMAP.md queue 3;
* ``NavierStokes3D(spectral_layout="packed")``: both packages construct it,
  and two RK4 steps of the port's packed layout match the reference's
  complex-layout steps (XLA; the reference's own oracle for its packed
  step, tests/test_packed_layout.py:77-94) and the port's complex layout,
  at 2e-5 of max |reference| (float32 FFTs through different libraries
  over 8 right-hand sides).  The reference's packed step itself takes
  ~25 s a step in interpret mode at these grids, so it is not run.

NS2D's packed layout: one RK4 step against the reference's packed step
(interpret mode) lane for lane, at 1e-5, at (40, 256) and (128, 2048); at
(16, 2048) against the reference's complex-layout step (jnp.fft), at 2e-5,
since the reference's packed step there is NaN: at n = 2048 its z kernel's
row tile is 128 (the VMEM budget is negative) and 16 rows make a grid of
no blocks (the same defect).

On the CPU the port runs its kernels' plain twins through the same glue;
tests/test_torch_kernels_cuda.py and chip_smoke.py hold the kernels
themselves at these plans on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mpifft4py_tpu import line as jline
from mpifft4py_tpu import slab as jslab
from mpifft4py_tpu.models.navier_stokes import NavierStokes3D as JNS
from mpifft4py_tpu.models.navier_stokes_2d import NavierStokes2D as JNS2
from mpifft4py_tpu.ops import pallas_fft3d as jp3
from mpifft4py_tpu_torch import (packed_state_from_reference,
                                 state_from_reference)
from mpifft4py_tpu_torch import line as tline
from mpifft4py_tpu_torch import slab as tslab
from mpifft4py_tpu_torch.models import NavierStokes2D as TNS2
from mpifft4py_tpu_torch.models import NavierStokes3D as TNS
from mpifft4py_tpu_torch.ops import fft3d as tp3
from test_torch_ns2d import _close_pair
from test_torch_packed import (_close, _f32,  # noqa: F401
                               _one_torch_thread, _t)

TAU = 2 * np.pi
STEP_TOL = 2e-5
GRIDS = [(26, 40, 256), (16, 24, 1280), (16, 16, 2048)]


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture
def force_dist(monkeypatch):
    """The reference's packed interface off the TPU (slab.py:713-715)."""
    monkeypatch.setenv("MPIFFT4PY_TPU_PALLAS_DIST", "force")


# -- the predicates -----------------------------------------------------------------

def test_predicates_match_reference():
    for n in range(1, 2049):
        assert tp3._factor(n) == jp3._factor(n), n
        assert tp3.supported_c2c(n) == jp3.supported_c2c(n), n
        assert tp3.supported_r2c(n) == jp3.supported_r2c(n), n
        assert tp3.curl_fused_ok(n) == tp3.fft_x_epilogue_ok(n) \
            == tp3.supported_c2c(n), n
        assert tp3.cross_zy_ok(n, 256) == tp3.supported_c2c(n), n
        assert tp3.cross_zy_ok(16, n) == tp3.supported_r2c(n), n
    # the grids the parent refused and the reference takes
    for n in (24, 26, 40, 112, 160, 320, 640, 1016):
        assert tp3.supported_c2c(n)
    for n in (1280, 1536, 2042, 2048):
        assert tp3.supported_r2c(n)


# -- the packed 3D layout ---------------------------------------------------------------

@pytest.mark.parametrize("shape", GRIDS)
def test_packed_interface_matches_reference(rng, force_dist, shape):
    L = np.array([TAU] * 3)
    J = jslab.R2C(np.array(shape), L, 1, "single")
    T = tslab.R2C(np.array(shape), L, None, "single", device="cpu")
    assert J._pallas_dist_ok("2/3-rule") and T._packed_iface_ok("2/3-rule")
    assert J.packed_z_perm is None and T.packed_z_perm is None
    u = _f32(rng, shape)
    ref = jax.jit(J.forward_packed_fn("2/3-rule"))(jnp.asarray(u))
    got = T.forward_packed_fn("2/3-rule")(_t(u))
    _close(got, ref)
    _close(T.backward_packed_fn()(got),
           jax.jit(J.backward_packed_fn())(ref))


def _state(J, shape, seed=7):
    """Taylor–Green plus a seeded perturbation, 2/3-rule masked (no
    Nyquist rider in the packed pair), complex64 numpy."""
    U = np.asarray(J.taylor_green())
    rng = np.random.default_rng(seed)
    p = np.fft.rfftn(rng.standard_normal((3,) + shape), axes=(1, 2, 3))
    U = U + 0.05 * p / np.abs(p).max() * np.abs(U).max()
    return (U * np.asarray(J.FFT.get_dealias_filter())).astype(np.complex64)


@pytest.mark.parametrize("shape", GRIDS)
def test_packed_ns3d_matches_reference(monkeypatch, shape):
    L = np.array([TAU] * 3)
    # explicit viscosity: nu·k²·dt stays below RK4's bound at k2 = 682
    kw = dict(nu=0.0005, dt=0.001, dealias="2/3-rule", integrator="RK4")
    # both gates accept the packed layout at this grid
    monkeypatch.setenv("MPIFFT4PY_TPU_PALLAS_DIST", "force")
    JNS(jslab.R2C(np.array(shape), L, 1, "single"), spectral_layout="packed",
        **kw)
    monkeypatch.delenv("MPIFFT4PY_TPU_PALLAS_DIST")   # the oracle: XLA
    J = JNS(jslab.R2C(np.array(shape), L, 1, "single"), **kw)
    FFT = tslab.R2C(np.array(shape), L, None, "single", device="cpu")
    Tc, Tp = TNS(FFT, **kw), TNS(FFT, spectral_layout="packed", **kw)
    U = _state(J, shape)
    sj, sc = jnp.asarray(U), state_from_reference(U, FFT)
    sp = Tp.to_packed(sc)
    assert sp.shape == (2, 3) + shape[:2] + (shape[2] // 2,)
    step = jax.jit(J.step)
    for _ in range(2):
        sj, sc, sp = step(sj), Tc.step(sc), Tp.step(sp)
    got = Tp.from_packed(sp).numpy()
    _close(got, np.asarray(sj), STEP_TOL)
    _close(got, sc.numpy(), STEP_TOL)
    assert Tp.energy(sp) < Tp.energy(Tp.to_packed(
        state_from_reference(U, FFT)))


# -- the packed 2D layout ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(40, 256), (128, 2048)])
def test_packed_ns2d_matches_reference(shape):
    L = np.array([TAU] * 2)
    kw = dict(nu=0.01, dt=0.001, spectral_layout="packed")
    J = JNS2(jline.R2C(np.array(shape), L, 1, "single"), **kw)
    T = TNS2(tline.R2C(np.array(shape), L, None, "single", device="cpu"),
             **kw)
    assert not T._dif and not J._dif              # natural lane order
    assert np.array_equal(T.k0.numpy(), np.asarray(J.k0))
    assert np.array_equal(T.k1.numpy(), np.asarray(J.k1))
    w = J.vortex_pair()
    S = packed_state_from_reference(tuple(np.asarray(a) for a in w), T.FFT)
    _close_pair(T.vortex_pair(), w)
    _close_pair(T.step(S), jax.jit(J.step)(w))
    assert T.enstrophy(T.step(S)) < T.enstrophy(S)


def test_packed_ns2d_2048_matches_reference_complex_step():
    shape = (16, 2048)
    L = np.array([TAU] * 2)
    kw = dict(nu=0.01, dt=0.001)
    J = JNS2(jline.R2C(np.array(shape), L, 1, "single"), **kw)
    T = TNS2(tline.R2C(np.array(shape), L, None, "single", device="cpu"),
             spectral_layout="packed", **kw)
    w = J.vortex_pair()
    S = T.pack_state(state_from_reference(np.asarray(w), T.FFT))
    _close(T.unpack_state(T.step(S)).numpy(), jax.jit(J.step)(w), STEP_TOL)


def test_full_size_packed_grids_construct():
    """The packed grids chip_smoke.py steps on the card, refused before the
    kernels took the reference's envelope: NS3D (320, 320, 1280) (radix 5
    on every axis, h = 640) and NS2D (1024, 2048) (h = 1024; N0 = 2048 is
    outside the reference's packed 2D gate, r = 16 > 8)."""
    F = tslab.R2C(np.array([320, 320, 1280]), np.array([TAU] * 3), None,
                  "single", device="cpu")
    assert TNS(F, nu=0.000625, dt=0.01, spectral_layout="packed").FFT is F
    G = tline.R2C(np.array([1024, 2048]), np.array([TAU] * 2), None,
                  "single", device="cpu")
    assert not TNS2(G, nu=0.001, dt=0.001, spectral_layout="packed")._dif
