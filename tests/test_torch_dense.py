"""The port's dense tier (``ops/dense.py``, rows 19–22) against the JAX
package's ``ops/pallas_fft.py``.

On the CPU the port's functions run their plain twins (``torch.fft``); the
reference's are its Pallas kernels in interpret mode.  Rows 19–20
(``fft_axis`` on a non-last and on the last axis), 21 (``rfft_last``) and 22
(``irfft_last``) at even n ∈ {16, 40, 112}, forward and inverse, at 1e-5 of
max |reference| (float32 sums in different orders: the kernels agree to
~3e-7).  At odd n ∈ {15, 41} ``rfft_last`` matches the reference, but the
reference's ``irfft_last`` does not compute numpy's ``irfft``: it weights
its last column as a Nyquist column (``pallas_fft.py:258-261``), which odd n
has not, so there the port is held to ``np.fft.irfft`` instead (ROADMAP.md
queue 3).  The kernels themselves are held to these twins on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mpifft4py_tpu.ops import pallas_fft as jpf
from mpifft4py_tpu_torch.ops import dense as td
from mpifft4py_tpu_torch.ops import fft3d as tp3
from test_torch_packed import _close, _one_torch_thread  # noqa: F401

NS = (16, 40, 112)


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _c64(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("n", NS)
def test_fft_axis_matches_pallas(rng, n, axis, inverse):
    """Rows 19 (axes 0 and 1, post > 1) and 20 (axis 2, post == 1)."""
    shape = [3, 5, 6]
    shape[axis] = n
    x = _c64(rng, tuple(shape))
    ref = np.asarray(jpf.fft_axis(jnp.asarray(x), axis, inverse))
    got = td.fft_axis(torch.from_numpy(x), axis, inverse)
    assert got.dtype == torch.complex64
    _close(got.numpy(), ref)
    fn = np.fft.ifft if inverse else np.fft.fft
    _close(got.numpy(), fn(x.astype(np.complex128), axis=axis))


@pytest.mark.parametrize("n", NS + (15, 41))
def test_rfft_last_matches_pallas(rng, n):
    x = rng.standard_normal((4, 3, n)).astype(np.float32)
    ref = np.asarray(jpf.rfft_last(jnp.asarray(x)))
    got = td.rfft_last(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == (4, 3, n // 2 + 1)
    _close(got.numpy(), ref)
    _close(got.numpy(), np.fft.rfft(x.astype(np.float64)))


@pytest.mark.parametrize("n", NS)
def test_irfft_last_matches_pallas(rng, n):
    X = _c64(rng, (4, 3, n // 2 + 1))
    ref = np.asarray(jpf.irfft_last(jnp.asarray(X), n))
    got = td.irfft_last(torch.from_numpy(X), n)
    assert got.dtype == torch.float32 and got.shape == (4, 3, n)
    _close(got.numpy(), ref)
    _close(got.numpy(), np.fft.irfft(X.astype(np.complex128), n))


@pytest.mark.parametrize("n", [15, 41])
def test_irfft_last_odd_n_is_numpys(rng, n):
    """At odd n the reference's ``irfft_last`` (pallas_fft.py:258-261)
    sets the weight of its last column to 1, as for a Nyquist column;
    odd n has no Nyquist column, so its result is not numpy's ``irfft``
    (0.36 of max |x| off at n = 15).  The port computes numpy's."""
    x = rng.standard_normal((8, n)).astype(np.float32)
    X = np.fft.rfft(x).astype(np.complex64)
    got = td.irfft_last(torch.from_numpy(X), n).numpy()
    _close(got, np.fft.irfft(X.astype(np.complex128), n))
    assert np.abs(got - x).max() < 1e-5 * np.abs(x).max()
    ref = np.asarray(jpf.irfft_last(jnp.asarray(X), n))
    assert np.abs(ref - x).max() > 1e-2 * np.abs(x).max()   # the defect


def test_dense_functions_launch_nothing_on_the_cpu(rng):
    before = dict(tp3.LAUNCHES)
    x = torch.from_numpy(_c64(rng, (4, 16)))
    td.fft_axis(x, 0)
    td.fft_axis(x, 1, inverse=True)
    td.irfft_last(td.rfft_last(x.real.contiguous()), 16)
    assert tp3.LAUNCHES == before


def test_dense_functions_reject_outside_the_envelope(rng):
    assert td.c2c_ok(1024) and not td.c2c_ok(1025) and not td.c2c_ok(1)
    assert td.r2c_ok(2048) and td.r2c_ok(1023) and td.r2c_ok(3)
    assert not td.r2c_ok(2050) and not td.r2c_ok(1025) and not td.r2c_ok(2)
    with pytest.raises(ValueError):
        td.fft_axis(torch.zeros((4, 2048), dtype=torch.complex64), 1)
    with pytest.raises(ValueError):
        td.rfft_last(torch.zeros((4, 1025)))
    with pytest.raises(ValueError):
        td.irfft_last(torch.zeros((4, 9), dtype=torch.complex64), 20)
    with pytest.raises(TypeError):
        td.fft_axis(torch.zeros((4, 16)), 0)              # real input
    with pytest.raises(TypeError):
        td.rfft_last(torch.zeros((4, 16), dtype=torch.float64))
    with pytest.raises(ValueError):
        td.fft_axis(torch.zeros((16, 4), dtype=torch.complex64).t(), 0)
