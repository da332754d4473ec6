"""The port's NavierStokes3D (complex layout) against the JAX package's.

Both solvers step the identical state: the reference's Taylor–Green
spectrum plus a numpy-seeded, 2/3-rule-dealiased perturbation, handed to the
port with ``state_from_reference``.  States are compared after 1 and 3
steps, relative to the largest reference coefficient: 1e-11 in double,
2e-5 in single (float32 FFTs through different libraries, over up to 12
right-hand sides).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpifft4py_tpu import slab as jslab
from mpifft4py_tpu.models import diagnostics as jdiag
from mpifft4py_tpu.models.navier_stokes import NavierStokes3D as JNS
from mpifft4py_tpu_torch import slab as tslab
from mpifft4py_tpu_torch import state_from_reference
from mpifft4py_tpu_torch.models import diagnostics as tdiag
from mpifft4py_tpu_torch.models.navier_stokes import NavierStokes3D as TNS
from test_torch_packed import _one_torch_thread  # noqa: F401

TAU = 2 * np.pi
N = (16, 16, 16)
TOL = {"double": 1e-11, "single": 2e-5}
CASES = [("RK4", None), ("LSRK54", None), ("Euler", None), ("AB2", None),
         ("RK4", (1.0, 3.0))]


def _solvers(precision, integrator="RK4", forcing=None):
    L = np.array([TAU] * 3)
    kw = dict(nu=0.01, dt=0.01, dealias="2/3-rule", integrator=integrator)
    if forcing is not None:
        kw.update(forcing_band=forcing, forcing_rate=0.1)
    J = JNS(jslab.R2C(np.array(N), L, 1, precision), **kw)
    T = TNS(tslab.R2C(np.array(N), L, None, precision, device="cpu"), **kw)
    return J, T


def _state(J, seed=7):
    """Taylor–Green plus a seeded dealiased perturbation, as numpy."""
    U = np.asarray(J.taylor_green())
    rng = np.random.default_rng(seed)
    p = np.fft.rfftn(rng.standard_normal((3,) + N), axes=(1, 2, 3))
    p *= np.asarray(J.FFT.get_dealias_filter())
    return (U + 0.05 * p / np.abs(p).max() * np.abs(U).max()).astype(U.dtype)


def _close(got, ref, tol):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("precision", ["double", "single"])
@pytest.mark.parametrize("integrator,forcing", CASES)
def test_steps_match_reference(precision, integrator, forcing):
    J, T = _solvers(precision, integrator, forcing)
    U = _state(J)
    sj, st = jnp.asarray(U), state_from_reference(U, T.FFT)
    if integrator == "AB2":
        sj, st = J.ab2_state(sj), T.ab2_state(st)
    for n in range(1, 4):
        sj, st = J.step(sj), T.step(st)
        if n in (1, 3):
            _close(T._carry_state(st), J._carry_state(sj), TOL[precision])


@pytest.mark.parametrize("precision", ["double", "single"])
def test_taylor_green_and_diagnostics_match_reference(precision):
    J, T = _solvers(precision)
    tol = TOL[precision]
    U0 = T.taylor_green()
    _close(U0, J.taylor_green(), tol)
    assert abs(T.energy(U0) - 0.125) < (1e-12 if precision == "double" else 1e-6)
    U = _state(J)
    st = state_from_reference(U, T.FFT)
    assert abs(T.energy(st) - J.energy(jnp.asarray(U))) <= tol
    es_t = tdiag.energy_spectrum(T.FFT, st)
    es_j = jdiag.energy_spectrum(J.FFT, jnp.asarray(U))
    assert np.abs(es_t - es_j).max() <= tol * np.abs(es_j).max()
    eps_t = tdiag.dissipation(T.FFT, st, 0.01)
    eps_j = jdiag.dissipation(J.FFT, jnp.asarray(U), 0.01)
    assert abs(eps_t - eps_j) <= tol * abs(eps_j)
    _close(T.rhs_with_state(st), J.rhs_with_state(jnp.asarray(U)), tol)


def test_run_monitor_matches_steps():
    _, T = _solvers("double")
    U0 = T.taylor_green()
    U, trace = T.run(U0, 4, monitor_every=2)
    V = T.step(T.step(U0))
    _close(T.run(V, 2), U.numpy(), 1e-14)
    assert trace.shape == (2,) and bool((trace < 0.125).all())
    assert abs(float(trace[-1]) - T.energy(U)) < 1e-12


def test_state_from_reference_checks_shape_and_dtype():
    J, T = _solvers("single")
    U = _state(J)
    assert state_from_reference(U, T.FFT).dtype == torch.complex64
    with pytest.raises(TypeError):
        state_from_reference(U.astype(np.complex128), T.FFT)
    with pytest.raises(ValueError):
        state_from_reference(U[..., :-1], T.FFT)


def test_unported_layout_raises():
    FFT = tslab.R2C(np.array(N), np.array([TAU] * 3), None, "single",
                    device="cpu")
    # the packed layout's envelope is the reference's: (N2/2) % 128 == 0
    with pytest.raises(ValueError, match="packed"):
        TNS(FFT, nu=0.01, dt=0.01, spectral_layout="packed")
    with pytest.raises(ValueError):
        TNS(FFT, nu=0.01, dt=0.01, spectral_layout="wide")
    with pytest.raises(ValueError):
        TNS(FFT, nu=0.01, dt=0.01, integrator="RK3")
