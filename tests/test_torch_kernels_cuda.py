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

from mpifft4py_tpu_torch.models import (MHD3D, Boussinesq3D, NavierStokes3D,
                                        VorticityVelocity3D)
from mpifft4py_tpu_torch.ops import fft3d as p3
from mpifft4py_tpu_torch.slab import C2C, R2C

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


def _kvecs(shape, device):
    """The packed layout's 1-D wavenumbers (k0, k1, k2), scaled per axis,
    and 2/3-rule masks (m0, m1, m2) for (N0, N1, h)."""
    n0, n1, h = shape
    k = (np.fft.fftfreq(n0, 1 / n0), np.fft.fftfreq(n1, 1 / n1),
         np.arange(h))
    m = [np.abs(v) < 2 / 3 * (n // 2) for v, n in zip(k, (n0, n1, 2 * h))]
    k = [v * sc for v, sc in zip(k, (1.0, 0.5, 2.0))]
    return tuple(torch.as_tensor(np.asarray(v, np.float32), device=device)
                 for v in k + m)


# packed (3, N0, N1, h): the 256^3 shapes' x lengths, the T = 8 and T = 4
# tiles (n0 = 384/512, 1024), and a ragged last tile (Q = 15 < T)
PACKED = [(3, 16, 16, 128), (3, 256, 4, 128), (3, 384, 3, 64),
          (3, 512, 4, 128), (3, 1024, 2, 128), (3, 48, 5, 3)]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("shape", PACKED)
def test_curl_ifft_x_matches_twin(cuda, shape, with_state):
    ur, ui = _f32(shape, cuda, 1), _f32(shape, cuda, 2)
    k = _kvecs(shape[1:], cuda)[:3]
    before = p3.LAUNCHES["curl_ifft_x"]
    got = p3.curl_ifft_x(ur, ui, *k, with_state)
    assert p3.LAUNCHES["curl_ifft_x"] == before + 1
    _close(got, p3.curl_ifft_x_ref(ur, ui, *k, with_state))


@pytest.mark.parametrize("shape", PACKED)
def test_fft_x_epilogue_matches_twin(cuda, shape):
    fr, fi, sr, si = (_f32(shape, cuda, j) for j in range(4))
    km = _kvecs(shape[1:], cuda)
    before = p3.LAUNCHES["fft_x_epilogue"]
    got = p3.fft_x_epilogue_packed(fr, fi, sr, si, *km, "project", 0.01)
    assert p3.LAUNCHES["fft_x_epilogue"] == before + 1
    _close(tuple(got),
           tuple(p3.fft_x_epilogue_packed_ref(fr, fi, sr, si, *km, "project",
                                              0.01)))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("shape", PACKED)
def test_curl_ifft_x_biot_savart_matches_twin(cuda, shape, with_state):
    ur, ui = _f32(shape, cuda, 1), _f32(shape, cuda, 2)
    k = _kvecs(shape[1:], cuda)[:3]
    before = p3.LAUNCHES["curl_ifft_x_biot_savart"]
    got = p3.curl_ifft_x(ur, ui, *k, with_state, True)
    assert p3.LAUNCHES["curl_ifft_x_biot_savart"] == before + 1
    _close(got, p3.curl_ifft_x_ref(ur, ui, *k, with_state, True))


@pytest.mark.parametrize("variant", ["curl", "div", "buoy"])
@pytest.mark.parametrize("shape", PACKED)
def test_fft_x_epilogue_variants_match_twin(cuda, shape, variant):
    fr, fi, sr, si, tr, ti = (_f32(shape, cuda, j) for j in range(6))
    if variant == "div":
        sr, si = sr[:1], si[:1]
    mode = "project" if variant == "buoy" else variant
    buoy = (tr[:1], ti[:1], 0.7) if variant == "buoy" else None
    km = _kvecs(shape[1:], cuda)
    name = f"fft_x_epilogue_{variant}"
    before = p3.LAUNCHES[name]
    got = p3.fft_x_epilogue_packed(fr, fi, sr, si, *km, mode, 0.01,
                                   buoy=buoy)
    assert p3.LAUNCHES[name] == before + 1
    _close(tuple(got), tuple(p3.fft_x_epilogue_packed_ref(
        fr, fi, sr, si, *km, mode, 0.01, buoy=buoy)))


@pytest.mark.parametrize("shape", [(3, 4, 64, 256), (3, 2, 512, 512),
                                   (3, 7, 16, 48), (3, 3, 24, 1024)])
def test_cross_rfft_z_matches_twin(cuda, shape):
    a, b = _f32(shape, cuda, 1), _f32(shape, cuda, 2)
    before = p3.LAUNCHES["cross_rfft_z"]
    got = p3.cross_rfft_z(a, b)
    assert p3.LAUNCHES["cross_rfft_z"] == before + 1
    _close(got, p3.cross_rfft_z_ref(a, b))
    _close(p3.cross_rfft_zy_packed(a, b), p3.cross_rfft_zy_packed_ref(a, b))


@pytest.mark.parametrize("shape", [(3, 4, 64, 256), (3, 2, 512, 512),
                                   (3, 7, 16, 48), (3, 3, 24, 1024)])
def test_cross2_and_mul_rfft_z_match_twin(cuda, shape):
    a, b, c, d = (_f32(shape, cuda, j) for j in range(4))
    t = _f32((1,) + shape[1:], cuda, 5)
    before = dict(p3.LAUNCHES)
    got2, gotm = p3.cross_rfft_z(a, b, c, d), p3.mul_rfft_z(a, t)
    assert p3.LAUNCHES["cross2_rfft_z"] == before["cross2_rfft_z"] + 1
    assert p3.LAUNCHES["mul_rfft_z"] == before["mul_rfft_z"] + 1
    _close(got2, p3.cross_rfft_z_ref(a, b, c, d))
    _close(gotm, p3.mul_rfft_z_ref(a, t))
    _close(p3.cross_rfft_zy_packed(a, b, c, d),
           p3.cross_rfft_zy_packed_ref(a, b, c, d))
    _close(p3.mul_rfft_zy_packed(a, t), p3.mul_rfft_zy_packed_ref(a, t))


def test_curl_irfft3d_packed_matches_twin(cuda):
    shape = (3, 16, 32, 128)
    ur, ui = _f32(shape, cuda, 1), _f32(shape, cuda, 2)
    k = _kvecs(shape[1:], cuda)[:3]
    s = (16, 32, 256)
    _close(p3.curl_irfft3d_packed(ur, ui, *k, s, with_state=True),
           p3.curl_irfft3d_packed_ref(ur, ui, *k, s, with_state=True))


def test_packed_step_on_the_card_matches_complex(cuda):
    FFT = R2C(np.array([32, 32, 256]), np.array([2 * np.pi] * 3), None,
              "single", device=cuda)
    c = NavierStokes3D(FFT, nu=0.01, dt=0.01)
    p = NavierStokes3D(FFT, nu=0.01, dt=0.01, spectral_layout="packed")
    Uc, Up = c.taylor_green(), p.taylor_green()
    for _ in range(2):
        Uc, Up = c.step(Uc), p.step(Up)
    torch.cuda.synchronize()
    err = float(torch.linalg.vector_norm(p.from_packed(Up) - Uc)
                / torch.linalg.vector_norm(Uc))
    assert err <= 1e-5


@pytest.mark.parametrize("model", ["VV", "MHD", "Boussinesq"])
def test_family_packed_steps_on_the_card_match_complex(cuda, model):
    FFT = R2C(np.array([32, 32, 256]), np.array([2 * np.pi] * 3), None,
              "single", device=cuda)
    cls, kw, init = {
        "VV": (VorticityVelocity3D, {}, "taylor_green"),
        "MHD": (MHD3D, {"eta": 0.02}, "taylor_green_mhd"),
        "Boussinesq": (Boussinesq3D, {"kappa": 0.02},
                       "taylor_green_stratified")}[model]
    c = cls(FFT, nu=0.01, dt=0.01, **kw)
    p = cls(FFT, nu=0.01, dt=0.01, spectral_layout="packed", **kw)
    Sc, Sp = getattr(c, init)(), getattr(p, init)()
    for _ in range(2):
        Sc, Sp = c.step(Sc), p.step(Sp)
    torch.cuda.synchronize()
    err = float(torch.linalg.vector_norm(p.from_packed(Sp) - Sc)
                / torch.linalg.vector_norm(Sc))
    assert err <= 1e-5


def test_wrapper_rejects_a_cpu_cuda_mix(cuda):
    x = _f32((4, 16, 8), cuda)
    with pytest.raises(ValueError):
        p3.fft_axis_planar(x, x.cpu(), 1)


# planar r2c / c2r (rows 8-9): n = 384 has RB = 21 rows a block, so 7 and
# 50 rows end in a partial block; nf = h + 1 (the Nyquist from plane 0)
# against nf < h (truncated, column nf-1 doubled) and nf = h
PLANAR = [((7, 384), None), ((50, 384), 129), ((2, 25, 384), 192),
          ((33, 48), 17), ((65, 256), None), ((9, 1024), 300), ((4, 16), 5)]


@pytest.mark.parametrize("shape,nf", PLANAR)
def test_planar_rfft_matches_twin(cuda, shape, nf):
    x = _f32(shape, cuda)
    before = p3.LAUNCHES["planar_rfft_last"]
    got = p3.rfft_last_planar(x, nf, 1 / 1.5 ** 3)
    assert p3.LAUNCHES["planar_rfft_last"] == before + 1
    _close(got, p3.rfft_last_planar_ref(x, nf, 1 / 1.5 ** 3))


@pytest.mark.parametrize("shape,nf", PLANAR)
def test_planar_irfft_matches_twin(cuda, shape, nf):
    n = shape[-1]
    w = n // 2 + 1 if nf is None else nf
    xr = _f32(shape[:-1] + (w,), cuda, 1)
    xi = _f32(shape[:-1] + (w,), cuda, 2)
    before = p3.LAUNCHES["planar_irfft_last"]
    got = p3.irfft_last_planar(xr, xi, n, nf, 1.5 ** 3)
    assert p3.LAUNCHES["planar_irfft_last"] == before + 1
    _close(got, p3.irfft_last_planar_ref(xr, xi, n, nf, 1.5 ** 3))


# n = 384 has RB = 10 rows a block, so 7 and 2·129 rows end in a partial
# block; the scale is the 3/2 rule's, folded into its z stage
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(7, 384), (33, 256), (5, 1024), (24, 16),
                                   (3, 11, 48), (2, 129, 192), (2, 129, 384)])
def test_fft_last_matches_twin(cuda, shape, inverse):
    xr, xi = _f32(shape, cuda, 1), _f32(shape, cuda, 2)
    sc = 1.5 ** 3 if inverse else 1 / 1.5 ** 3
    before = p3.LAUNCHES["fft_last"]
    got = p3.fft_last_planar_c2c(xr, xi, inverse)
    assert p3.LAUNCHES["fft_last"] == before + 1
    _close(got, p3.fft_last_planar_c2c_ref(xr, xi, inverse))
    _close(p3.fft_last_planar_c2c(xr, xi, inverse, sc),
           p3.fft_last_planar_c2c_ref(xr, xi, inverse, sc))


def test_c2c_on_the_card_matches_float64(cuda):
    N = (32, 48, 64)
    C = C2C(np.array(N), np.array([2 * np.pi] * 3), None, "single",
            device=cuda)
    u = torch.complex(_f32(N, cuda, 1), _f32(N, cuda, 2))
    fu = C.fftn(u)
    _close(fu.to(torch.complex128), torch.fft.fftn(u.to(torch.complex128)))
    for dealias in (None, "3/2-rule"):
        back = C.fftn(C.ifftn(fu, dealias=dealias), dealias=dealias)
        torch.cuda.synchronize()
        assert float((back - fu).abs().max()) < 1e-6 * float(fu.abs().max())
    # the 3/2 rule's kernel chain against its torch.fft route (at N, M =
    # 48·72·96 is outside the kernels' envelope)
    C = C2C(np.array((32, 32, 64)), np.array([2 * np.pi] * 3), None,
            "single", device=cuda)
    assert C._kernel_ok("3/2-rule")
    up = torch.complex(*(_f32((3,) + C.work_shape("3/2-rule"), cuda, s)
                         for s in (3, 4)))
    before = p3.LAUNCHES["fft_last"]
    fu = C.forward_fn("3/2-rule")(up)
    _close(fu, C._fwd_torch(up, "3/2-rule"))
    _close(C.backward_fn("3/2-rule")(fu), C._bwd_torch(fu, "3/2-rule"))
    assert p3.LAUNCHES["fft_last"] == before + 2


def test_padded_r2c_on_the_card_matches_torch_route(cuda):
    N = (32, 32, 64)
    FFT = R2C(np.array(N), np.array([2 * np.pi] * 3), None, "single",
              device=cuda)
    assert FFT._padded_kernel_ok()
    up = _f32((3,) + FFT.work_shape("3/2-rule"), cuda)
    before = dict(p3.LAUNCHES)
    fu = FFT.forward_fields_fn("3/2-rule")(up)
    _close(fu, FFT._fwd_torch(up, "3/2-rule"))
    _close(FFT.backward_fields_fn("3/2-rule")(fu),
           FFT._bwd_torch(fu, "3/2-rule"))
    for k in ("planar_rfft_last", "planar_irfft_last", "fft_axis"):
        assert p3.LAUNCHES[k] > before[k]
    fu = FFT.fftn(_f32(N, cuda, 3))                    # a Hermitian spectrum
    back = FFT.fftn(FFT.ifftn(fu, dealias="3/2-rule"), dealias="3/2-rule")
    torch.cuda.synchronize()
    assert float((back - fu).abs().max()) < 1e-6 * float(fu.abs().max())
