"""The port's CUDA kernels against their plain torch.fft twins, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  This file imports neither JAX nor the JAX
package, so it runs on a machine with the card and no JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_kernels_cuda.py -q

Tolerance: 1e-5 of max |twin| (the kernels agree to ~3e-7).
"""

import numpy as np
import pytest
import torch

from mpifft4py_tpu_torch.ops import fft3d as p3
from mpifft4py_tpu_torch.slab import R2C

pytestmark = pytest.mark.cuda

RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _f32(shape, device, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device)


def _close(got, ref):
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= RTOL * float(r.abs().max())


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape,axis", [((4, 16, 8), 1), ((384, 6), 0),
                                        ((3, 256, 128), 1), ((256, 4096), 0),
                                        ((2, 768, 33), 1), ((1024, 64), 0),
                                        ((24, 5), 0)])
def test_fft_axis_matches_twin(cuda, shape, axis, inverse):
    xr, xi = _f32(shape, cuda, 1), _f32(shape, cuda, 2)
    before = p3.LAUNCHES["fft_axis"]
    got = p3.fft_axis_planar(xr, xi, axis, inverse)
    assert p3.LAUNCHES["fft_axis"] == before + 1
    _close(got, p3.fft_axis_planar_ref(xr, xi, axis, inverse))


@pytest.mark.parametrize("shape", [(4, 16), (3, 48), (1000, 256), (7, 384),
                                   (65, 512), (9, 1024), (33, 24)])
def test_packed_last_matches_twin(cuda, shape):
    x = _f32(shape, cuda)
    ref = p3.rfft_last_packed_ref(x)
    _close(p3.rfft_last_packed(x), ref)
    _close(p3.irfft_last_packed(*ref, shape[-1]),
           p3.irfft_last_packed_ref(*ref, shape[-1]))


def test_fused_zy_matches_twin(cuda):
    u = _f32((2, 64, 256), cuda)
    _close(p3.fused_zy_fwd(u), p3.fused_zy_fwd_ref(u))
    yr, yi = _f32((2, 64, 128), cuda, 1), _f32((2, 64, 128), cuda, 2)
    _close(p3.fused_zy_bwd(yr, yi, 256), p3.fused_zy_bwd_ref(yr, yi, 256))


def test_r2c_on_the_card_matches_float64(cuda):
    N = (64, 96, 128)
    FFT = R2C(np.array(N), np.array([2 * np.pi] * 3), None, "single",
              device=cuda)
    u = _f32(N, cuda)
    fu = FFT.fftn(u)
    _close(fu.to(torch.complex128), torch.fft.rfftn(u.double()))
    back = FFT.ifftn(fu)
    torch.cuda.synchronize()
    assert float((back - u).abs().max()) < 1e-6 * float(u.abs().max())


def test_wrapper_rejects_a_cpu_cuda_mix(cuda):
    x = _f32((4, 16, 8), cuda)
    with pytest.raises(ValueError):
        p3.fft_axis_planar(x, x.cpu(), 1)
