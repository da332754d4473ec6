"""The port's 2D family against the JAX package: the DIF lane order and its
kernels (rows 17–18), ``line.R2C`` and ``NavierStokes2D`` in both layouts.

Kernels: the port's row 17/18 functions (on the CPU, their plain twins)
against ``pallas_zdif.rfft_last_zdif``/``irfft_last_zdif`` in interpret
mode, at 1e-5 of max |reference|; the twins are the natural packed twins
permuted, exactly.  ``line.R2C``: forward and inverse against the
reference's for every ``dealias``, at 1e-6 (single) and 1e-12 (double) of
max |reference|.  NS2D: one RK4 step of the port's packed layout against
the reference's packed step (Pallas in interpret mode) lane for lane, at
(32, 256) (natural lanes) and (32, 512) (zdif lanes), at 1e-5; the complex
layout against the reference's jitted complex step under the 2/3 and the
3/2 rule, at 1e-11 (double) and 2e-5 (single).  The reference's solvers
and jitted steps are built once per module.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mpifft4py_tpu import line as jline
from mpifft4py_tpu.models.navier_stokes_2d import NavierStokes2D as JNS2
from mpifft4py_tpu.ops import pallas_zdif as jzd
from mpifft4py_tpu_torch import (packed_state_from_reference,
                                 state_from_reference)
from mpifft4py_tpu_torch import line as tline
from mpifft4py_tpu_torch.models import NavierStokes2D as TNS2
from mpifft4py_tpu_torch.ops import fft3d as tp3
from mpifft4py_tpu_torch.ops import zdif as tzd
from test_torch_packed import (_close, _f32,  # noqa: F401
                               _one_torch_thread, _t)

TAU = 2 * np.pi
NS = (512, 768, 1024)
KW = dict(nu=0.01, dt=0.001)


def _close_pair(got, ref, rtol=1e-5):
    """A packed pair against the reference's, relative to the largest
    coefficient of the two planes together (the vortex pair's spectrum is
    imaginary up to round-off, so its real plane alone is noise)."""
    got, ref = np.stack([np.asarray(a) for a in got]), np.stack(
        [np.asarray(a) for a in ref])
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


# -- the DIF lane order --------------------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_zdif_maps_match_reference(rng, n):
    perm, iperm = tzd.zdif_perm(n), tzd.zdif_iperm(n)
    assert np.array_equal(perm, jzd.zdif_perm(n))
    assert np.array_equal(iperm, jzd.zdif_iperm(n))
    assert tzd._piece_offsets(n) == jzd._piece_offsets(n)
    lanes = np.arange(n // 2)
    assert np.array_equal(tzd.zdif_lane(tzd.zdif_k(lanes, n), n), lanes)
    x = _f32(rng, (3, n // 2))
    got = tzd.dif_interleave(_t(x), n).numpy()
    assert np.array_equal(got, np.asarray(jzd.dif_interleave(jnp.asarray(x),
                                                             n)))
    assert np.array_equal(got, x[..., iperm])
    got = tzd.dif_deinterleave(_t(x), n).numpy()
    assert np.array_equal(got, np.asarray(
        jzd.dif_deinterleave(jnp.asarray(x), n)))
    assert np.array_equal(got, x[..., perm])


def test_zdif_gate_matches_reference():
    for n in range(128, 2049, 64):
        assert tzd.zdif_ok(n) == jzd.zdif_ok(n), n
    with pytest.raises(ValueError):
        tzd.zdif_perm(256)


# -- rows 17-18 ----------------------------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_zdif_functions_match_pallas(rng, n):
    x = _f32(rng, (16, n))
    _close(tzd.rfft_last_zdif(_t(x)), jzd.rfft_last_zdif(jnp.asarray(x)))
    xr, xi = _f32(rng, (2, 8, n // 2)), _f32(rng, (2, 8, n // 2))
    _close(tzd.irfft_last_zdif(_t(xr), _t(xi), n),
           jzd.irfft_last_zdif(jnp.asarray(xr), jnp.asarray(xi), n))


@pytest.mark.parametrize("n", NS)
def test_zdif_twins_are_the_natural_twins_permuted(rng, n):
    """Row 17's twin is row 4's permuted to zdif_perm, exactly; row 18's
    twin of that pair is row 5's of the natural pair, exactly; the
    ``dif=True`` route of the packed functions is rows 17-18."""
    x = _t(_f32(rng, (8, n)))
    yr, yi = tp3.rfft_last_packed_ref(x)
    p = torch.from_numpy(tzd.zdif_perm(n))
    zr, zi = tzd.rfft_last_zdif_ref(x)
    assert torch.equal(zr, yr[..., p]) and torch.equal(zi, yi[..., p])
    assert torch.equal(tzd.irfft_last_zdif_ref(zr, zi, n),
                       tp3.irfft_last_packed_ref(yr, yi, n))
    got = tp3.rfft_last_packed(x, dif=True)
    assert torch.equal(got[0], zr) and torch.equal(got[1], zi)
    assert torch.equal(tp3.irfft_last_packed(zr, zi, n, dif=True),
                       tp3.irfft_last_packed_ref(yr, yi, n))


def test_dif_outside_the_gate_keeps_natural_order(rng):
    x = _t(_f32(rng, (4, 256)))
    got, ref = tp3.rfft_last_packed(x, dif=True), tp3.rfft_last_packed_ref(x)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(ValueError):
        tzd.rfft_last_zdif(x)
    with pytest.raises(ValueError):
        tzd.irfft_last_zdif(*ref, 256)


# -- line.R2C --------------------------------------------------------------------------

def _lines(shape, precision):
    L = np.array([TAU, 2.0])
    return (jline.R2C(np.array(shape), L, 1, precision),
            tline.R2C(np.array(shape), L, None, precision, device="cpu"))


@pytest.mark.parametrize("dealias", [None, "2/3-rule", "3/2-rule"])
@pytest.mark.parametrize("precision", ["single", "double"])
@pytest.mark.parametrize("shape", [(32, 32), (16, 48), (32, 512)])
def test_line_fft2_ifft2_match_reference(rng, shape, precision, dealias):
    J, T = _lines(shape, precision)
    tol = 1e-6 if precision == "single" else 1e-12
    ft = np.float32 if precision == "single" else np.float64
    assert T.global_complex_shape() == J.global_complex_shape()
    assert T.work_shape(dealias) == J.work_shape(dealias)
    u = rng.standard_normal(J.work_shape(dealias)).astype(ft)
    ref = np.asarray(J.fft2(jnp.asarray(u), dealias=dealias))
    got = T.fft2(u, dealias=dealias)
    assert got.dtype == T.complex
    _close(got.numpy(), ref, tol)
    fu = np.asarray(J.fft2(jnp.asarray(rng.standard_normal(shape).astype(ft))))
    ref = np.asarray(J.ifft2(jnp.asarray(fu), dealias=dealias))
    got = T.ifft2(fu, dealias=dealias)
    assert got.dtype == T.float and got.shape == ref.shape
    _close(got.numpy(), ref, tol)


@pytest.mark.parametrize("precision", ["single", "double"])
def test_line_meshes_match_reference(precision):
    J, T = _lines((16, 48), precision)
    for name in ("get_local_wavenumbermesh",
                 "get_scaled_local_wavenumbermesh", "get_dealias_filter",
                 "get_local_mesh"):
        ref = np.asarray(getattr(J, name)())
        got = getattr(T, name)().numpy()
        assert got.dtype == ref.dtype and np.array_equal(got, ref), name
    assert (T.Nf, T.Nfp, T.Mf, T.Mfp) == (J.Nf, J.Nfp, J.Mf, J.Mfp)
    assert np.array_equal(T.M, J.M)
    for name in ("real_shape", "complex_shape", "real_shape_padded",
                 "global_real_shape_padded", "real_local_slice",
                 "complex_local_slice"):
        assert getattr(T, name)() == getattr(J, name)(), name
    with pytest.raises(ValueError):
        tline.R2C(np.array([16, 15]), np.array([TAU] * 2), device="cpu")
    with pytest.raises(ValueError):
        T.forward_fn("4/3-rule")


# -- NavierStokes2D ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def packed_pairs():
    """(reference, port) packed solvers at (32, 256) and (32, 512), the
    reference's step jitted once, each with the reference's vortex pair."""
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for shape in ((32, 256), (32, 512)):
            L = np.array([TAU] * 2)
            J = JNS2(jline.R2C(np.array(shape), L, 1, "single"),
                     spectral_layout="packed", **KW)
            T = TNS2(tline.R2C(np.array(shape), L, None, "single",
                               device="cpu"), spectral_layout="packed", **KW)
            w = J.vortex_pair()
            out[shape] = (J, T, w, J.step(w))
    return out


@pytest.mark.parametrize("shape", [(32, 256), (32, 512)])
def test_packed_step_matches_reference_lane_for_lane(packed_pairs, shape):
    J, T, w, w1 = packed_pairs[shape]
    assert T._dif == J._dif == (shape[1] >= 512)
    assert np.array_equal(T.k0.numpy(), np.asarray(J.k0))
    assert np.array_equal(T.k1.numpy(), np.asarray(J.k1))
    assert np.array_equal(T._mask_pk(T.k0, T.k1).numpy(),
                          np.asarray(J._mask_pk(J.k0, J.k1)))
    S = packed_state_from_reference(tuple(np.asarray(a) for a in w), T.FFT)
    assert S.shape == (2, shape[0], shape[1] // 2)
    _close_pair(T.vortex_pair(), w)
    _close_pair(T.step(S), w1)


@pytest.mark.parametrize("shape", [(32, 256), (32, 512)])
def test_packed_state_boundary_matches_reference(packed_pairs, shape):
    J, T, w, _ = packed_pairs[shape]
    S = packed_state_from_reference(tuple(np.asarray(a) for a in w), T.FFT)
    C = T.unpack_state(S)
    _close(C.numpy(), J.unpack_state(w))
    back = T.pack_state(C)
    _close_pair(back, S, 1e-6)
    _close_pair(back, J.pack_state(J.unpack_state(w)), 1e-6)
    assert abs(T.enstrophy(S) - J.enstrophy(w)) <= 1e-5 * J.enstrophy(w)


def test_packed_run_decays_and_matches_steps(packed_pairs):
    _, T, w, _ = packed_pairs[(32, 512)]
    S = packed_state_from_reference(tuple(np.asarray(a) for a in w), T.FFT)
    out = T.run(S, 3)
    V = S
    for _ in range(3):
        V = T.step(V)
    assert torch.equal(out, V)
    assert T.enstrophy(out) < T.enstrophy(S)


@pytest.mark.parametrize("precision,dealias,tol", [
    ("double", "2/3-rule", 1e-11), ("double", "3/2-rule", 1e-11),
    ("single", "2/3-rule", 2e-5)])
def test_complex_step_matches_reference(precision, dealias, tol):
    L = np.array([TAU] * 2)
    shape = (32, 48)
    J = JNS2(jline.R2C(np.array(shape), L, 1, precision), dealias=dealias,
             **KW)
    T = TNS2(tline.R2C(np.array(shape), L, None, precision, device="cpu"),
             dealias=dealias, **KW)
    w = np.asarray(J.vortex_pair())
    _close(T.vortex_pair().numpy(), w, 1e-6 if precision == "single"
           else 1e-12)
    S = state_from_reference(w, T.FFT)
    sj, st = jnp.asarray(w), S
    for _ in range(2):
        sj, st = J.step(sj), T.step(st)
    _close(st.numpy(), sj, tol)
    assert abs(T.enstrophy(st) - J.enstrophy(sj)) <= 1e-5 * J.enstrophy(sj)
    assert T.enstrophy(st) < T.enstrophy(S)


@pytest.mark.parametrize("integrator", ["LSRK54", "Euler", "AB2"])
def test_packed_integrators_match_complex(integrator):
    """The packed layout steps as the complex one (the port's own oracle:
    the complex step is held to the reference above)."""
    F = tline.R2C(np.array([32, 512]), np.array([TAU] * 2), None, "single",
                  device="cpu")
    c = TNS2(F, integrator=integrator, **KW)
    p = TNS2(F, integrator=integrator, spectral_layout="packed", **KW)
    sc = c.vortex_pair()
    sp = p.pack_state(sc)
    if integrator == "AB2":
        sc, sp = c.ab2_state(sc), p.ab2_state(sp)
    for _ in range(2):
        sc, sp = c.step(sc), p.step(sp)
    if integrator == "AB2":
        sc, sp = sc[0], sp[0]
    _close(p.unpack_state(sp).numpy(), sc.numpy(), 2e-5)


def test_packed_gate_refuses_what_the_reference_refuses():
    L = np.array([TAU] * 2)

    def both(shape, dealias="2/3-rule"):
        for cls, line, kw in ((JNS2, jline.R2C, {}),
                              (TNS2, tline.R2C, {"device": "cpu"})):
            with pytest.raises(ValueError, match="packed 2D"):
                cls(line(np.array(shape), L, 1, "single", **kw),
                    dealias=dealias, spectral_layout="packed", **KW)
    both((32, 192))                       # h = 96: the lane gate fails
    both((32, 256), dealias=None)
    both((2048, 256))                     # N0 = 16·128: r > 8
    # both accept N0 = 40 (r = 1, m = 40) and N1 = 2048; above 2048 the
    # reference's gate accepts N1 but its z kernels stop (supported_r2c),
    # and the port's gate refuses it
    for shape in ((40, 256), (16, 2048)):
        JNS2(jline.R2C(np.array(shape), L, 1, "single"),
             spectral_layout="packed", **KW)
        TNS2(tline.R2C(np.array(shape), L, None, "single", device="cpu"),
             spectral_layout="packed", **KW)
    with pytest.raises(ValueError, match="envelope"):
        TNS2(tline.R2C(np.array([16, 4096]), L, None, "single",
                       device="cpu"), spectral_layout="packed", **KW)
    F = tline.R2C(np.array([32, 256]), L, None, "single", device="cpu")
    with pytest.raises(ValueError):
        TNS2(F, spectral_layout="wide", **KW)
    with pytest.raises(ValueError):
        TNS2(F, integrator="RK3", **KW)
    with pytest.raises(ValueError):
        TNS2(F, **KW).ab2_state(None)


def test_state_transfer_checks_2d_shapes():
    F = tline.R2C(np.array([32, 256]), np.array([TAU] * 2), None, "single",
                  device="cpu")
    pair = (np.zeros((32, 128), np.float32),) * 2
    assert packed_state_from_reference(pair, F).shape == (2, 32, 128)
    with pytest.raises(ValueError):
        packed_state_from_reference(tuple(a[None] for a in pair), F)
    w = np.zeros((32, 129), np.complex64)
    assert state_from_reference(w, F).shape == (32, 129)
    with pytest.raises(ValueError):
        state_from_reference(w[None], F)
    with pytest.raises(TypeError):
        state_from_reference(w.astype(np.complex128), F)
