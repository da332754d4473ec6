"""The port's ``slab.C2C`` and its last-axis c2c kernel against the JAX
package.

Kernels: the port's ``fft_last_planar_c2c`` and ``cfft3d`` (on the CPU the
kernels' plain twins through the same glue) against the reference's Pallas
functions in interpret mode (cf. tests/test_pallas_fft.py:84).  The slab:
``slab.C2C`` at (16, 16, 128) with ``dealias`` None, "2/3-rule" and
"3/2-rule", in "single" and "double", against the reference's XLA path,
its Pallas pipeline (``MPIFFT4PY_TPU_PALLAS_DIST=force``, float32, no 3/2
rule there) and ``np.fft.fftn``.  Tolerances, relative to max
|reference|: 1e-5 in float32, 1e-12 in float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mpifft4py_tpu import slab as jslab
from mpifft4py_tpu.ops import pallas_fft3d as jp3
from mpifft4py_tpu_torch import slab as tslab
from mpifft4py_tpu_torch.ops import fft3d as tp3
from test_torch_packed import _one_torch_thread  # noqa: F401

TAU = 2 * np.pi
N = (16, 16, 128)
TOL = {"single": 1e-5, "double": 1e-12}
CTYPE = {"single": np.complex64, "double": np.complex128}
DEALIAS = [None, "2/3-rule", "3/2-rule"]


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _close(got, ref, tol=1e-5):
    got = [np.asarray(g) for g in (got if isinstance(got, tuple) else (got,))]
    ref = [np.asarray(r) for r in (ref if isinstance(ref, tuple) else (ref,))]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= tol * np.abs(r).max()


def _c(rng, shape, precision="single"):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(CTYPE[precision])


def _pair(precision, L=None):
    L = np.array([TAU] * 3) if L is None else np.asarray(L)
    return (jslab.C2C(np.array(N), L, 1, precision),
            tslab.C2C(np.array(N), L, None, precision, device="cpu"))


# -- the kernels --------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 1 / 1.5 ** 3])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_last_planar_c2c_matches_pallas(rng, inverse, scale):
    """``scale`` (the port's own argument, which the 3/2 chain uses) against
    the reference's unscaled result times ``scale``."""
    xr = rng.standard_normal((3, 4, 128)).astype(np.float32)
    xi = rng.standard_normal((3, 4, 128)).astype(np.float32)
    ref = jp3.fft_last_planar_c2c(jnp.asarray(xr), jnp.asarray(xi), inverse)
    got = tp3.fft_last_planar_c2c(torch.from_numpy(xr), torch.from_numpy(xi),
                                  inverse, scale)
    _close(got, tuple(np.asarray(r) * np.float32(scale) for r in ref))


@pytest.mark.parametrize("inverse", [False, True])
def test_cfft3d_matches_pallas(rng, inverse):
    x = _c(rng, N)
    got = tp3.cfft3d(torch.from_numpy(x), inverse).numpy()
    _close(got, jp3.cfft3d(jnp.asarray(x), inverse))
    ref = np.fft.ifftn(x) if inverse else np.fft.fftn(x)
    _close(got, ref)


def test_c2c_wrappers_reject_outside_envelope(rng):
    x = torch.zeros((4, 1018))
    with pytest.raises(ValueError):
        tp3.fft_last_planar_c2c(x, x)                       # 1018 = 2·509
    with pytest.raises(ValueError):
        tp3.fft_last_planar_c2c(x[:, :16], x[:, :8])        # re/im shapes
    with pytest.raises(TypeError):
        tp3.cfft3d(torch.zeros((16, 16, 16), dtype=torch.complex128))
    # the port's last-axis envelope is supported_c2c, not 128 lanes
    assert tp3.supported_c2c(48) and not jp3.supported_c2c_last(48)


# -- slab.C2C ---------------------------------------------------------------------------

@pytest.mark.parametrize("dealias", DEALIAS)
@pytest.mark.parametrize("precision", ["single", "double"])
def test_c2c_matches_reference(rng, precision, dealias):
    J, T = _pair(precision)
    assert T._kernel_ok(dealias) == (precision == "single")
    u = _c(rng, T.work_shape(dealias), precision)
    ft = T.fftn(u, dealias=dealias)
    assert ft.shape == T.complex_shape() == N and ft.dtype == T.complex
    _close(ft.numpy(), J.fftn(u, dealias=dealias), TOL[precision])
    if dealias is None:
        _close(ft.numpy(), np.fft.fftn(u.astype(np.complex128)),
               TOL[precision])
    fu = _c(rng, N, precision)
    _close(T.ifftn(fu, dealias=dealias).numpy(),
           J.ifftn(fu, dealias=dealias), TOL[precision])


@pytest.mark.parametrize("dealias", [None, "2/3-rule"])
def test_c2c_matches_reference_pallas(rng, monkeypatch, dealias):
    monkeypatch.setenv("MPIFFT4PY_TPU_PALLAS_DIST", "force")
    J, T = _pair("single")
    assert J._pallas_dist_ok(dealias)
    u = _c(rng, N)
    ft = T.fftn(u, dealias=dealias)
    _close(ft.numpy(), J.fftn(u, dealias=dealias))
    _close(T.ifftn(ft, dealias=dealias).numpy(),
           J.ifftn(ft.numpy(), dealias=dealias))


@pytest.mark.parametrize("precision", ["single", "double"])
def test_c2c_roundtrips(rng, precision):
    _, T = _pair(precision)
    tol = 1e-6 if precision == "single" else 1e-13
    u = _c(rng, N, precision)
    _close(T.ifftn(T.fftn(u)).numpy(), u, tol)
    # the 3/2 rule: fftn(ifftn(fu, 3/2), 3/2) == fu (split-Nyquist adjoint)
    fu = T.fftn(u)
    up = T.ifftn(fu, dealias="3/2-rule")
    assert tuple(up.shape) == T.global_real_shape_padded() == (24, 24, 192)
    _close(T.fftn(up, dealias="3/2-rule").numpy(), fu.numpy(), tol)


@pytest.mark.parametrize("precision", ["single", "double"])
def test_c2c_fields_match_reference(rng, precision):
    J, T = _pair(precision)
    U = _c(rng, (3,) + N, precision)
    FU = T.forward_fields_fn("2/3-rule")(T.shard_real(U))
    _close(FU.numpy(), jax.jit(J.forward_fields_fn("2/3-rule"))(
        J.shard_real(U)), TOL[precision])
    _close(T.backward_fields_fn()(FU).numpy(),
           jax.jit(J.backward_fields_fn())(J.shard_complex(FU.numpy())),
           TOL[precision])


def test_c2c_shape_helpers_match_reference():
    J, T = _pair("single")
    for name in ("real_shape", "complex_shape", "complex_shape_T",
                 "complex_shape_I", "global_real_shape", "global_complex_shape",
                 "real_shape_padded", "global_real_shape_padded",
                 "real_local_slice", "complex_local_slice"):
        assert getattr(T, name)() == getattr(J, name)(), name
    for d in DEALIAS:
        assert T.work_shape(d) == J.work_shape(d)
        assert T.global_work_shape(d) == J.global_work_shape(d)
    assert T.shard_real(np.zeros(N)).dtype == torch.complex64


@pytest.mark.parametrize("precision", ["single", "double"])
def test_c2c_meshes_match_reference(precision):
    J, T = _pair(precision, [TAU, 2.0, 3.5])
    _close(T.get_local_wavenumbermesh().numpy(), J.get_local_wavenumbermesh(),
           0)
    _close(T.get_scaled_local_wavenumbermesh().numpy(),
           J.get_scaled_local_wavenumbermesh(), TOL[precision])
    _close(T.get_local_mesh().numpy(), J.get_local_mesh(), TOL[precision])
    assert (T.get_dealias_filter().numpy()
            == np.asarray(J.get_dealias_filter())).all()


def test_c2c_kernel_gate_is_a_shape_predicate():
    def ok(shape, dealias=None, precision="single"):
        return tslab.C2C(np.array(shape), np.array([TAU] * 3), None,
                         precision, device="cpu")._kernel_ok(dealias)
    assert ok((16, 24, 48)) and ok((256, 256, 256), "3/2-rule")
    assert not ok((16, 16, 16), precision="double")
    assert not ok((16, 16, 1024), "3/2-rule")       # M2 = 1536
    assert not ok((262, 16, 16))                    # 262 = 2·131
    assert ok((20, 40, 112))                        # the reference's too
