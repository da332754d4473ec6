"""The port's serial tier (``mpifft4py_tpu_torch.serialFFT``) and package
surface against the JAX package's ``mpifft4py_tpu.serialFFT``.

Every function on the same numpy-seeded input, at 1e-5 of max |reference|
in float32 (complex64) and 1e-12 in float64 (the two packages' FFT
libraries sum in different orders); ``dct``/``idct`` types I–IV also
against ``scipy.fftpack`` with ``norm=None``.  ``rfftn``/``irfftn`` of a
3-D float32 grid in the kernels' envelope take the hand-written chain
(``ops.fft3d.rfft3d``/``irfft3d``; on the CPU its plain twins, so no launch
is counted), everything else ``torch.fft``, as the reference routes to its
Pallas chain on the TPU and to ``jnp.fft`` elsewhere.
"""

import numpy as np
import pytest
import scipy.fftpack as sfp
import torch

import jax.numpy as jnp

import mpifft4py_tpu as J
import mpifft4py_tpu_torch as T
from mpifft4py_tpu_torch.ops import fft3d as tp3
from mpifft4py_tpu_torch.serialFFT import torch_fft
from test_torch_packed import _close, _one_torch_thread  # noqa: F401

TOL = {np.float32: 1e-5, np.float64: 1e-12}
C2C = [("fft", {"axis": 0}), ("ifft", {}), ("fft2", {}),
       ("ifft2", {"axes": (0, 2)}), ("fftn", {}), ("ifftn", {"axes": (1,)})]
R2C = [("rfft", {}), ("rfft2", {"axes": (0, 1)}), ("rfftn", {}),
       ("rfftn", {"axes": (0, 2)})]
C2R = [("irfft", {"n": 10}), ("irfft", {}), ("irfft2", {"s": (6, 10)}),
       ("irfftn", {"s": (4, 6, 10)}), ("irfftn", {})]


def _real(rng, shape, dtype):
    return rng.standard_normal(shape).astype(dtype)


def _cplx(rng, shape, dtype):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.result_type(dtype,
                                                                    1j))


def _both(name, a, kw):
    ref = np.asarray(getattr(J, name)(jnp.asarray(a), **kw))
    got = getattr(T, name)(torch.from_numpy(a), **kw)
    assert tuple(got.shape) == ref.shape
    return got.numpy(), ref


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,kw", C2C)
def test_c2c_matches_reference(rng, name, kw, dtype):
    got, ref = _both(name, _cplx(rng, (4, 6, 10), dtype), kw)
    assert got.dtype == ref.dtype
    _close(got, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,kw", R2C)
def test_r2c_matches_reference(rng, name, kw, dtype):
    got, ref = _both(name, _real(rng, (4, 6, 10), dtype), kw)
    assert got.dtype == ref.dtype
    _close(got, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,kw", C2R)
def test_c2r_matches_reference(rng, name, kw, dtype):
    got, ref = _both(name, _cplx(rng, (4, 6, 6), dtype), kw)
    assert got.dtype == ref.dtype
    _close(got, ref, TOL[dtype])


@pytest.mark.parametrize("dct_type", [1, 2, 3, 4])
@pytest.mark.parametrize("axis", [-1, 0])
def test_dct_idct_match_reference_and_scipy(rng, dct_type, axis):
    x = _real(rng, (6, 9), np.float32)
    for fn in ("dct", "idct"):
        ref = np.asarray(getattr(J, fn)(jnp.asarray(x), type=dct_type,
                                        axis=axis))
        got = getattr(T, fn)(torch.from_numpy(x), type=dct_type, axis=axis)
        assert got.dtype == torch.float32
        _close(got.numpy(), ref)
        _close(got.numpy(), getattr(sfp, fn)(x.astype(np.float64),
                                             type=dct_type, axis=axis))
    n = x.shape[axis]
    back = T.idct(T.dct(torch.from_numpy(x), type=dct_type, axis=axis),
                  type=dct_type, axis=axis).numpy()
    _close(back, (2 * (n - 1) if dct_type == 1 else 2 * n) * x)


def test_kwargs_handling(rng):
    """The out argument and threads/planner_effort are accepted and ignored;
    other keywords raise TypeError in the FFTs (the DCTs ignore them, as the
    reference's do); an unknown DCT type raises NotImplementedError."""
    a = _cplx(rng, (4, 8), np.float32)
    out = T.fft(torch.from_numpy(a), torch.empty(4, 8, dtype=torch.complex64),
                threads=4, planner_effort="FFTW_MEASURE").numpy()
    _close(out, np.asarray(J.fft(jnp.asarray(a), None, threads=4,
                                 planner_effort="FFTW_MEASURE")))
    for pkg, arr in ((T, torch.from_numpy(a)), (J, jnp.asarray(a))):
        with pytest.raises(TypeError, match="unexpected kwargs"):
            pkg.ifft(arr, overwrite_input=True)
        with pytest.raises(TypeError, match="unexpected kwargs"):
            pkg.rfftn(arr.real, norm="ortho")
        pkg.dct(arr.real, threads=2, overwrite_x=True)
        with pytest.raises(NotImplementedError):
            pkg.dct(arr.real, type=5)
        with pytest.raises(NotImplementedError):
            pkg.idct(arr.real, type=0)


def test_rfftn_takes_the_kernel_chain_in_the_envelope(rng, monkeypatch):
    """A 3-D float32 grid in the envelope goes through ``fft3d.rfft3d``/
    ``irfft3d`` (on the CPU their twins: no launch counted); a grid outside
    it, float64 or other axes take ``torch.fft``."""
    calls = []
    for name in ("rfft3d", "irfft3d"):
        real = getattr(tp3, name)
        monkeypatch.setattr(tp3, name, lambda *a, real=real, name=name:
                            calls.append(name) or real(*a))
    before = dict(tp3.LAUNCHES)
    u = _real(rng, (16, 24, 40), np.float32)
    fu = torch_fft.rfftn(torch.from_numpy(u))
    _close(fu.numpy(), np.asarray(J.rfftn(jnp.asarray(u))))
    back = torch_fft.irfftn(fu, s=u.shape)
    _close(back.numpy(), u, 1e-6)
    assert calls == ["rfft3d", "irfft3d"] and tp3.LAUNCHES == before
    calls.clear()
    torch_fft.rfftn(torch.from_numpy(_real(rng, (16, 24, 14), np.float32)))
    torch_fft.rfftn(torch.from_numpy(u.astype(np.float64)))
    torch_fft.rfftn(torch.from_numpy(u), axes=(1, 2))
    torch_fft.irfftn(fu, s=(16, 24, 39))          # 39 // 2 + 1 == 20 != 21
    assert calls == []


def test_zeros_and_empty_on_an_explicit_cpu_device():
    z = T.zeros((3, 4), device="cpu")
    assert z.dtype == torch.float64 and z.device.type == "cpu"
    assert not z.any()
    e = T.empty([2, 5], np.complex64, device="cpu")
    assert e.dtype == torch.complex64 and e.shape == (2, 5) and not e.any()
    assert T.zeros((2,), torch.float32, device="cpu").dtype == torch.float32
    assert np.asarray(J.zeros((3, 4))).dtype == np.float64
