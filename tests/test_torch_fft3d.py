"""The port's FFT kernel functions (mpifft4py_tpu_torch.ops.fft3d) against
the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain twins; the reference's Pallas
functions run in interpret mode, as tests/test_pallas_fft.py runs them.
Inputs are made from a seed with numpy and fed to both.  Tolerance: 1e-5
of max |reference| (float32 FFTs of these lengths agree to ~1e-7).

The CUDA kernels themselves are held against their twins on the card by
tests/test_torch_kernels_cuda.py.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mpifft4py_tpu.ops import pallas_fft3d as jp3
from mpifft4py_tpu_torch.ops import fft3d as tp3
from test_torch_packed import _one_torch_thread  # noqa: F401

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, ref, rtol=RTOL):
    got = [np.asarray(g) for g in (got if isinstance(got, tuple) else (got,))]
    ref = [np.asarray(r) for r in (ref if isinstance(ref, tuple) else (ref,))]
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= rtol * np.abs(r).max()


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("n", [16, 48, 256, 384])
def test_fft_axis_planar_matches_pallas(rng, n, axis, inverse):
    shape = (2, n, 8) if axis == 1 else (n, 2, 8)
    xr, xi = _f32(rng, shape), _f32(rng, shape)
    ref = jp3.fft_axis_planar(jnp.asarray(xr), jnp.asarray(xi), axis=axis,
                              inverse=inverse)
    got = tp3.fft_axis_planar(_t(xr), _t(xi), axis, inverse)
    _close(got, ref)


def test_fused_zy_matches_pallas(rng):
    u = _f32(rng, (2, 16, 256))
    _close(tp3.fused_zy_fwd(_t(u)), jp3.fused_zy_fwd(jnp.asarray(u)))
    yr, yi = _f32(rng, (2, 16, 128)), _f32(rng, (2, 16, 128))
    _close(tp3.fused_zy_bwd(_t(yr), _t(yi), 256),
           jp3.fused_zy_bwd(jnp.asarray(yr), jnp.asarray(yi), 256))


def test_packed_last_matches_pallas(rng):
    x = _f32(rng, (4, 256))
    _close(tp3.rfft_last_packed(_t(x)), jp3.rfft_last_packed(jnp.asarray(x)))
    yr, yi = _f32(rng, (4, 128)), _f32(rng, (4, 128))
    _close(tp3.irfft_last_packed(_t(yr), _t(yi), 256),
           jp3.irfft_last_packed(jnp.asarray(yr), jnp.asarray(yi), 256))


def test_spectrum_boundary_matches_reference(rng):
    yr, yi = _f32(rng, (2, 8, 6, 5)), _f32(rng, (2, 8, 6, 5))
    jr, ji = jnp.asarray(yr), jnp.asarray(yi)
    fu = tp3.unpack_spectrum(_t(yr), _t(yi))
    _close(fu.numpy(), jp3.unpack_spectrum(jr, ji))
    _close(tp3.pack_spectrum(fu), jp3.pack_spectrum(jnp.asarray(fu.numpy())))
    _close(tp3.purify_plane0(_t(yr), _t(yi)), jp3.purify_plane0(jr, ji))
    p0, pny = tp3.unpack_plane0(_t(yr), _t(yi), axes=(1, 2))
    j0, jny = jp3.unpack_plane0(jr, ji, axes=(1, 2))
    _close((p0.numpy(), pny.numpy()), (j0, jny))
    _close(tp3.pack_plane0(p0, pny), jp3.pack_plane0(j0, jny))


@pytest.mark.parametrize("shape", [(16, 24, 32), (3, 16, 16, 48)])
def test_rfft3d_round_trip_against_numpy(rng, shape):
    u = _f32(rng, shape)
    fu = tp3.rfft3d(_t(u))
    _close(fu.numpy(), np.fft.rfftn(u.astype(np.float64), axes=(-3, -2, -1)))
    back = tp3.irfft3d(fu, shape)
    assert np.abs(back.numpy() - u).max() < 1e-6 * np.abs(u).max()


def test_wrappers_reject_outside_envelope(rng):
    x = _t(_f32(rng, (4, 131, 8)))
    with pytest.raises(ValueError):
        tp3.fft_axis_planar(x, x, 1)                  # 131: a prime > 128
    with pytest.raises(ValueError):
        tp3.fft_axis_planar(x, x, 2)                  # last axis
    with pytest.raises(TypeError):
        tp3.fft_axis_planar(x.double(), x.double(), 0)
    y = _t(_f32(rng, (16, 16, 8)))
    with pytest.raises(ValueError):
        tp3.fft_axis_planar(y.transpose(0, 1), y.transpose(0, 1), 0)
    with pytest.raises(ValueError):
        tp3.rfft_last_packed(_t(_f32(rng, (4, 2050))))  # above 2048
    with pytest.raises(ValueError):
        tp3.irfft_last_packed(y, y, 32)               # width 8 != 16


def test_envelope_predicates():
    """The reference's envelope (tests/test_torch_envelope.py holds the
    two packages' predicates equal for every n in 1..2048)."""
    ok = [8, 12, 16, 24, 40, 112, 127, 160, 384, 640, 768, 1016, 1024]
    assert all(tp3.supported_c2c(n) for n in ok)
    assert not any(tp3.supported_c2c(n)
                   for n in (4, 7, 131, 1018, 1152, 1536, 2048))
    assert tp3.supported_r2c(48) and tp3.supported_r2c(2042)
    assert not any(tp3.supported_r2c(n) for n in (14, 17, 2049, 2050))


def test_port_imports_no_jax():
    root = Path(tp3.__file__).resolve().parents[1]
    smoke = root.parent / "chip_smoke.py"
    for path in [*root.rglob("*.py"), smoke]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert not top.startswith("jax"), (path, name)
                assert top != "mpifft4py_tpu", (path, name)
