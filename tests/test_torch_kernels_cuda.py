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

from mpifft4py_tpu_torch.line import R2C as LineR2C
from mpifft4py_tpu_torch.models import (MHD3D, Boussinesq3D, NavierStokes2D,
                                        NavierStokes3D, VorticityVelocity3D)
from mpifft4py_tpu_torch.ops import fft3d as p3
from mpifft4py_tpu_torch.ops import zdif as zd
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


def _view(n, rows, off, device, seed):
    """(rows, n) float32 that starts `off` values into a larger buffer (a
    base that is not 16-byte aligned unless off * 4 is a multiple of 16)."""
    return _f32((rows * n + off,), device, seed)[off:].view(rows, n)


def _round_trip(fwd, bwd, xs):
    back = bwd(*fwd(*xs))
    torch.cuda.synchronize()
    back = back if isinstance(back, tuple) else (back,)
    for b, x in zip(back, xs):
        assert float((b - x).abs().max()) < 1e-6 * float(x.abs().max())


# the persistent kernel's edges (rows 10 and 20): views that start one row
# (n = 129) or a few values into a larger buffer, so every tile's head and
# tail miss the 16-byte grid of the bulk copies; row counts that are not a
# multiple of a tile's rows (28 planar, 30 complex64 at n = 129; 16 at 256;
# 10 at 384) and leave most of the persistent grid without a tile; n = 384
# with the 3/2 rule's scale; each against its twin and in a round trip
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,rows,off", [(129, 300, 129), (129, 201, 1),
                                        (256, 201, 0), (256, 300, 1),
                                        (384, 7, 3), (384, 1000, 2)])
def test_fft_last_unaligned_and_ragged(cuda, n, rows, off, inverse):
    xr, xi = _view(n, rows, off, cuda, 1), _view(n, rows, off, cuda, 2)
    sc = 1.5 ** 3 if inverse else 1 / 1.5 ** 3
    before = p3.LAUNCHES["fft_last"]
    got = p3.fft_last_planar_c2c(xr, xi, inverse, sc)
    assert p3.LAUNCHES["fft_last"] == before + 1
    _close(got, p3.fft_last_planar_c2c_ref(xr, xi, inverse, sc))
    _round_trip(lambda a, b: p3.fft_last_planar_c2c(a, b, inverse, sc),
                lambda a, b: p3.fft_last_planar_c2c(a, b, not inverse,
                                                    1 / sc), (xr, xi))
    from mpifft4py_tpu_torch.ops import dense as dn
    buf = torch.complex(_f32((rows * n + off,), cuda, 3),
                        _f32((rows * n + off,), cuda, 4))
    x = buf[off:].view(rows, n)
    before = p3.LAUNCHES["dense_fft_last"]
    _close(torch.view_as_real(dn.fft_axis(x, 1, inverse)),
           torch.view_as_real(dn.fft_axis_ref(x, 1, inverse)))
    assert p3.LAUNCHES["dense_fft_last"] == before + 1
    _round_trip(lambda a: (dn.fft_axis(a, 1, inverse),),
                lambda a: dn.fft_axis(a, 1, not inverse), (x,))


# the persistent column kernel's edges (rows 1 and 19, fft_axis.cu): inputs
# and ``out=`` views that start 1-3 values into larger buffers (row
# segments off the bulk copies' 16-byte grid, each plane off by another
# amount), posts of 1, 3, 129 (row 19's 1032-byte complex64 rows, a last
# tile of one column) and 130, pre > 1, and the lengths whose tiles are
# one 32-byte sector wide (384, 640, 1016, 1024); each against its twin
# and in a round trip
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("pre,n,post,off", [
    (1, 256, 129, 1), (3, 384, 1, 2), (2, 640, 3, 3), (3, 1016, 130, 1),
    (2, 1024, 129, 2), (5, 256, 130, 3), (1, 384, 4096, 1),
    (4, 1024, 3, 0)])
def test_fft_axis_unaligned_and_ragged(cuda, pre, n, post, off, inverse):
    shape = (pre, n, post)
    count = pre * n * post

    def view(seed, o):
        return _f32((count + o,), cuda, seed)[o:].view(shape)
    xr, xi = view(1, off), view(2, (off + 1) % 4)
    out = (view(3, (off + 2) % 4), view(4, (off + 3) % 4))
    before = p3.LAUNCHES["fft_axis"]
    got = p3.fft_axis_planar(xr, xi, 1, inverse, out=out)
    assert p3.LAUNCHES["fft_axis"] == before + 1
    assert got[0].data_ptr() == out[0].data_ptr()
    _close(got, p3.fft_axis_planar_ref(xr, xi, 1, inverse))
    _round_trip(lambda a, b: p3.fft_axis_planar(a, b, 1, inverse),
                lambda a, b: p3.fft_axis_planar(a, b, 1, not inverse),
                (xr, xi))
    from mpifft4py_tpu_torch.ops import dense as dn
    buf = torch.complex(_f32((count + off,), cuda, 5),
                        _f32((count + off,), cuda, 6))
    x = buf[off:].view(shape)
    name = "dense_fft_last" if post == 1 else "dense_fft_axis"
    before = p3.LAUNCHES[name]
    _close(torch.view_as_real(dn.fft_axis(x, 1, inverse)),
           torch.view_as_real(dn.fft_axis_ref(x, 1, inverse)))
    assert p3.LAUNCHES[name] == before + 1
    _round_trip(lambda a: (dn.fft_axis(a, 1, inverse),),
                lambda a: dn.fft_axis(a, 1, not inverse), (x,))


# the persistent r2c's edges (rows 21 and 8, planar_rfft_kernel): inputs
# that start one value or one row into a larger buffer (the bulk copies'
# heads and tails), 201 rows and 3-stacks whose row counts are not a
# multiple of a tile's rows (32 at n = 256, 20 at n = 384), the 3/2 rule's
# truncated z stage (nf = 129, doubled, scaled) and the pencil's widths 130
# and 132 through out= (a pair that may itself start one value into a
# buffer); each against its twin and in a round trip through the c2r
@pytest.mark.parametrize("shape,off,nf,width,out_off", [
    ((4096, 256), 1, None, None, 0), ((4096, 256), 256, None, None, 0),
    ((201, 256), 0, None, None, 0), ((3, 67, 256), 1, None, None, 0),
    ((3, 7, 384), 0, 129, None, 0), ((201, 384), 1, 129, None, 0),
    ((1000, 384), 384, None, None, 0), ((128, 128, 256), 0, 129, 130, 0),
    ((201, 256), 1, 129, 130, 1), ((3, 67, 256), 3, 129, 132, 2)])
def test_planar_rfft_unaligned_and_ragged(cuda, shape, off, nf, width,
                                          out_off):
    from mpifft4py_tpu_torch.ops import dense as dn
    n = shape[-1]
    x = _f32((int(np.prod(shape)) + off,), cuda, 5)[off:].view(shape)
    if nf is not None:
        # band-limited to the nf columns (the 3/2 rule's padded field), so
        # the truncated forward and the c2r's pad are a round trip
        sr, si = (_f32(shape[:-1] + (nf,), cuda, s) for s in (6, 7))
        x.copy_(p3.irfft_last_planar_ref(sr, si, n, nf))
    sc = 1 / 1.5 ** 3 if n == 384 else 1.0
    out = None
    if width is not None:
        rows = int(np.prod(shape[:-1]))
        out = tuple(torch.zeros(rows * width + out_off, device=cuda)
                    [out_off:].view(shape[:-1] + (width,)) for _ in "ri")
    before = p3.LAUNCHES["planar_rfft_last"]
    got = p3.rfft_last_planar(x, nf, sc, width, out)
    assert p3.LAUNCHES["planar_rfft_last"] == before + 1
    _close(got, p3.rfft_last_planar_ref(x, nf, sc, width))
    if out is not None:
        assert got[0].data_ptr() == out[0].data_ptr()
    _round_trip(lambda a: p3.rfft_last_planar(a, nf, sc, width),
                lambda a, b: p3.irfft_last_planar(a, b, n, nf, 1 / sc), (x,))
    if nf is None:
        before = p3.LAUNCHES["dense_rfft_last"]
        X = dn.rfft_last(x)
        assert p3.LAUNCHES["dense_rfft_last"] == before + 1
        _close(torch.view_as_real(X),
               torch.view_as_real(dn.rfft_last_ref(x)))
        _round_trip(lambda a: (dn.rfft_last(a),),
                    lambda a: dn.irfft_last(a, n), (x,))


# rows 4 and 17 on the same persistent r2c (planar_rfft_kernel's packed
# modes): inputs 1-3 values into a larger buffer, stacks that end in a
# partial tile (32 rows a tile at n = 256, 16 at 512, 10 at 768, 8 at 1024,
# 4 at 2042), the DIF order; each against its twin and in a round trip
# through the packed c2r
@pytest.mark.parametrize("shape,off,dif", [
    ((4096, 256), 1, False), ((201, 256), 2, False), ((3, 67, 256), 3, False),
    ((33, 2042), 1, False), ((7, 16), 3, False), ((201, 512), 1, True),
    ((3, 25, 768), 2, True), ((1000, 1024), 3, True), ((9, 1024), 0, True)])
def test_packed_rfft_unaligned_and_ragged(cuda, shape, off, dif):
    n = shape[-1]
    x = _f32((int(np.prod(shape)) + off,), cuda, 5)[off:].view(shape)
    name = "packed_rfft_last" + ("_zdif" if dif else "")
    fwd = zd.rfft_last_zdif if dif else p3.rfft_last_packed
    before = p3.LAUNCHES[name]
    got = fwd(x)
    assert p3.LAUNCHES[name] == before + 1
    _close(got, (zd.rfft_last_zdif_ref if dif else p3.rfft_last_packed_ref)(x))
    _round_trip(fwd, lambda a, b: p3.irfft_last_packed(a, b, n, dif=dif),
                (x,))


# the packed launchers with spectra 1-3 values into their buffers (the
# wrappers allocate aligned ones), and a base off the 4-byte grid, refused
@pytest.mark.parametrize("rows,n,off,dif", [
    (77, 256, 1, False), (77, 1024, 2, False), (9, 2042, 3, False),
    (77, 1024, 2, True), (25, 768, 3, True)])
def test_packed_rfft_launcher_unaligned_spectrum(cuda, rows, n, off, dif):
    from mpifft4py_tpu_torch.ops import _build
    h = n // 2
    x = _view(n, rows, off, cuda, 3)
    yr, yi = (torch.zeros(rows * h + off, device=cuda)[off:].view(rows, h)
              for _ in "ri")
    lib = _build.load()
    fn = lib.packed_rfft_zdif_launch if dif else lib.packed_rfft_launch
    tws = (p3._twiddles(h, h, -1, cuda).data_ptr(),
           p3._twiddles(n, h, -1, cuda).data_ptr())
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert fn(x.data_ptr(), yr.data_ptr(), yi.data_ptr(), *tws, rows, n,
              stream) == 0
    _close((yr, yi), (zd.rfft_last_zdif_ref if dif
                      else p3.rfft_last_packed_ref)(x))
    assert fn(x.data_ptr() + 2, yr.data_ptr(), yi.data_ptr(), *tws, rows, n,
              stream) != 0


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
    # the 3/2 rule's kernel chain against its torch.fft route
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


# rows 17-18, the DIF lane order: n = 512 (RB = 16), 768 (h = 384, the
# radix-3 stage, RB = 10: 7 and 25 rows end in a partial block) and 1024
# (RB = 8), the (4, 1024, 512) stack of NS2D's batched inverse among them
ZDIF = [(16, 512), (7, 768), (2, 25, 768), (1024, 1024), (4, 1024, 1024),
        (3, 512)]


@pytest.mark.parametrize("shape", ZDIF)
def test_zdif_kernels_match_twin(cuda, shape):
    n = shape[-1]
    x = _f32(shape, cuda)
    before = dict(p3.LAUNCHES)
    got = zd.rfft_last_zdif(x)
    assert p3.LAUNCHES["packed_rfft_last_zdif"] == \
        before["packed_rfft_last_zdif"] + 1
    _close(got, zd.rfft_last_zdif_ref(x))
    back = zd.irfft_last_zdif(*got, n)
    assert p3.LAUNCHES["packed_irfft_last_zdif"] == \
        before["packed_irfft_last_zdif"] + 1
    _close(back, x)
    yr, yi = _f32(got[0].shape, cuda, 1), _f32(got[0].shape, cuda, 2)
    _close(zd.irfft_last_zdif(yr, yi, n), zd.irfft_last_zdif_ref(yr, yi, n))


@pytest.mark.parametrize("n", [512, 768, 1024])
def test_zdif_forward_is_row_4_permuted(cuda, n):
    x = _f32((64, n), cuda)
    perm = torch.from_numpy(zd.zdif_perm(n)).to(cuda)
    nr, ni = p3.rfft_last_packed(x)
    _close(p3.rfft_last_packed(x, dif=True), (nr[:, perm], ni[:, perm]))
    _close(p3.irfft_last_packed(nr[:, perm], ni[:, perm], n, dif=True),
           p3.irfft_last_packed(nr, ni, n))


def test_zdif_launcher_refuses_outside_the_gate(cuda):
    from mpifft4py_tpu_torch.ops import _build
    x = _f32((4, 256), cuda)
    y = torch.empty((4, 128), device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    rc = _build.load().packed_rfft_zdif_launch(
        x.data_ptr(), y.data_ptr(), y.data_ptr(), None, None, 4, 256, stream)
    assert rc != 0


@pytest.mark.parametrize("n1", [256, 512, 768])
def test_ns2d_packed_step_on_the_card_matches_complex(cuda, n1):
    FFT = LineR2C(np.array([64, n1]), np.array([2 * np.pi] * 2), None,
                  "single", device=cuda)
    c = NavierStokes2D(FFT, nu=0.01, dt=0.001)
    p = NavierStokes2D(FFT, nu=0.01, dt=0.001, spectral_layout="packed")
    assert p._dif == (n1 >= 512)
    Wc, Wp = c.vortex_pair(), p.vortex_pair()
    before = dict(p3.LAUNCHES)
    for _ in range(2):
        Wc, Wp = c.step(Wc), p.step(Wp)
    torch.cuda.synchronize()
    z = "_zdif" if p._dif else ""
    assert p3.LAUNCHES["packed_irfft_last" + z] - \
        before["packed_irfft_last" + z] == 8
    assert p3.LAUNCHES["packed_rfft_last" + z] - \
        before["packed_rfft_last" + z] == 8
    err = float(torch.linalg.vector_norm(p.unpack_state(Wp) - Wc)
                / torch.linalg.vector_norm(Wc))
    assert err <= 1e-5


# -- the widened plans (radix 5 and 7, direct prime stages) ---------------------
#
# c2c n = 40 (2^3·5), 112 (2^4·7), 640 (2^7·5), 1016 (8·127: a direct
# 127-point stage); r2c n = 1280 (h = 640) and 2042 (h = 1021: a direct
# 1021-point stage).  The round trips are held to 1e-6 of max |x|.

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [40, 112, 640, 1016])
def test_widened_c2c_plans_match_twin(cuda, n, inverse):
    xr, xi = _f32((3, n, 20), cuda, 1), _f32((3, n, 20), cuda, 2)
    _close(p3.fft_axis_planar(xr, xi, 1, inverse),
           p3.fft_axis_planar_ref(xr, xi, 1, inverse))
    yr, yi = _f32((21, n), cuda, 3), _f32((21, n), cuda, 4)
    got = p3.fft_last_planar_c2c(yr, yi, inverse)
    _close(got, p3.fft_last_planar_c2c_ref(yr, yi, inverse))
    back = p3.fft_last_planar_c2c(*got, not inverse)
    torch.cuda.synchronize()
    assert float((back[0] - yr).abs().max()) < 1e-6 * float(yr.abs().max())
    shape = (3, n, 5, 64)
    ur, ui = _f32(shape, cuda, 5), _f32(shape, cuda, 6)
    k = _kvecs(shape[1:], cuda)
    _close(p3.curl_ifft_x(ur, ui, *k[:3], True),
           p3.curl_ifft_x_ref(ur, ui, *k[:3], True))
    _close(tuple(p3.fft_x_epilogue_packed(ur, ui, ur, ui, *k, "project",
                                          0.01)),
           tuple(p3.fft_x_epilogue_packed_ref(ur, ui, ur, ui, *k, "project",
                                              0.01)))


# the pair-sum prime stages of fft_last.cu: p = 11 twice (121), 43 after a
# radix 3 (129), 127 after radix 2 and 4 (1016), aligned and one value in;
# the dense tier's complex64 instance also at primes above 127 (131, 2·509,
# 1021), whose sums are compensated
@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("n", [22, 121, 129, 254, 1016])
def test_pairsum_plans_match_twin(cuda, n, off):
    xr, xi = _view(n, 21, off, cuda, 1), _view(n, 21, off, cuda, 2)
    for inverse in (False, True):
        _close(p3.fft_last_planar_c2c(xr, xi, inverse),
               p3.fft_last_planar_c2c_ref(xr, xi, inverse))
        _round_trip(lambda a, b: p3.fft_last_planar_c2c(a, b, inverse),
                    lambda a, b: p3.fft_last_planar_c2c(a, b, not inverse),
                    (xr, xi))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [131, 2 * 509, 1021])
def test_dense_fft_last_large_primes(cuda, n, inverse):
    from mpifft4py_tpu_torch.ops import dense as dn
    x = torch.complex(_f32((64, n), cuda, 1), _f32((64, n), cuda, 2))
    _close(torch.view_as_real(dn.fft_axis(x, 1, inverse)),
           torch.view_as_real(dn.fft_axis_ref(x, 1, inverse)))
    _round_trip(lambda a: (dn.fft_axis(a, 1, inverse),),
                lambda a: dn.fft_axis(a, 1, not inverse), (x,))


@pytest.mark.parametrize("n", [1280, 2042])
def test_widened_r2c_plans_match_twin(cuda, n):
    x = _f32((3, 5, n), cuda)
    ref = p3.rfft_last_packed_ref(x)
    got = p3.rfft_last_packed(x)
    _close(got, ref)
    _close(p3.irfft_last_packed(*ref, n), p3.irfft_last_packed_ref(*ref, n))
    back = p3.irfft_last_packed(*got, n)
    torch.cuda.synchronize()
    assert float((back - x).abs().max()) < 1e-6 * float(x.abs().max())
    _close(p3.rfft_last_planar(x), p3.rfft_last_planar_ref(x))
    b = _f32((3, 5, n), cuda, 7)
    _close(p3.cross_rfft_z(x, b), p3.cross_rfft_z_ref(x, b))


# -- the dense tier (rows 19-22, complex64 at the boundary) ----------------------

def _c64(shape, device, seed=0):
    return torch.complex(_f32(shape, device, seed), _f32(shape, device,
                                                           seed + 1))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape,axis,name", [
    ((4, 40, 33), 1, "dense_fft_axis"), ((112, 6), 0, "dense_fft_axis"),
    ((3, 640, 5), 1, "dense_fft_axis"), ((2, 7, 1016), 2, "dense_fft_last"),
    ((9, 15), 1, "dense_fft_last"), ((5, 256, 1), 1, "dense_fft_last")])
def test_dense_fft_axis_matches_twin(cuda, shape, axis, name, inverse):
    from mpifft4py_tpu_torch.ops import dense as dn
    x = _c64(shape, cuda)
    before = p3.LAUNCHES[name]
    got = dn.fft_axis(x, axis, inverse)
    assert p3.LAUNCHES[name] == before + 1
    _close(torch.view_as_real(got),
           torch.view_as_real(dn.fft_axis_ref(x, axis, inverse)))


@pytest.mark.parametrize("n", [16, 15, 40, 41, 112, 1023, 1280, 2042, 2048])
def test_dense_rfft_irfft_match_twin(cuda, n):
    from mpifft4py_tpu_torch.ops import dense as dn
    x = _f32((3, 7, n), cuda)
    before = dict(p3.LAUNCHES)
    X = dn.rfft_last(x)
    _close(torch.view_as_real(X), torch.view_as_real(dn.rfft_last_ref(x)))
    Y = _c64((3, 7, n // 2 + 1), cuda, 2)
    _close(dn.irfft_last(Y, n), dn.irfft_last_ref(Y, n))
    back = dn.irfft_last(X, n)
    torch.cuda.synchronize()
    assert float((back - x).abs().max()) < 1e-6 * float(x.abs().max())
    assert p3.LAUNCHES["dense_rfft_last"] == before["dense_rfft_last"] + 1
    assert p3.LAUNCHES["dense_irfft_last"] == before["dense_irfft_last"] + 2


# -- rows 23-25: the peer-memory transposes, P ranks emulated in-process ------
#
# A SymmetricBuffer.local table holds P tensors of this process; calling a
# kernel once with each ``my`` does what P ranks do, one launch each.

from mpifft4py_tpu_torch.parallel import rdma  # noqa: E402


def _blocks(shape, P, device):
    """Per-rank inputs whose every element names its rank, its block and
    its index, so a block in the wrong slot shows."""
    base = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    return [torch.from_numpy(base + 1e5 * r).to(device) for r in range(P)]


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("shape,split,concat", [((8, 16, 6), 1, 0),
                                                ((16, 8, 6), 0, 1),
                                                ((4, 6, 16), 2, 0),
                                                ((3, 8, 16, 5), 2, 1)])
def test_peer_a2a_matches_block_transpose(cuda, P, shape, split, concat):
    xs = _blocks(shape, P, cuda)
    out = list(shape)
    out[split] //= P
    out[concat] *= P
    for kernel in (True, False):
        buf = rdma.SymmetricBuffer.local(P, (2,) + tuple(out), cuda)
        before = rdma.LAUNCHES["peer_a2a"]
        for my in range(P):
            for leaf in range(2):
                x = xs[my] * (1 + leaf)
                if kernel:
                    rdma.a2a_push(x, buf, my, split, concat, leaf)
                else:
                    rdma.a2a_push_ref(x, buf, my, split, concat, leaf)
        assert rdma.LAUNCHES["peer_a2a"] == before + (2 * P if kernel else 0)
        torch.cuda.synchronize()
        for r in range(P):
            want = torch.cat([torch.chunk(xs[s], P, dim=split)[r]
                              for s in range(P)], dim=concat)
            for leaf in range(2):
                assert torch.equal(buf.tensors[r][leaf], want * (1 + leaf))


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("C,n0,n1,h", [(1, 256, 16, 128), (2, 40, 8, 6),
                                       (3, 16, 16, 256), (1, 640, 8, 4)])
def test_peer_fft_x_kernels_match_twins(cuda, P, C, n0, n1, h):
    np0, np1 = n0 // P, n1 // P
    pull = rdma.SymmetricBuffer.local(P, (2, C, np0, n1, h), cuda)
    for r, t in enumerate(pull.tensors):
        t.copy_(_f32(t.shape, cuda, 10 + r))
    for my in range(P):
        got = rdma.fft_x_pull(pull, my)
        _close((got[0], got[1]), tuple(rdma.fft_x_pull_ref(pull, my)))
    xs = [(_f32((C, n0, np1, h), cuda, 20 + r), _f32((C, n0, np1, h), cuda,
                                                      40 + r))
          for r in range(P)]
    got = rdma.SymmetricBuffer.local(P, (2, C, np0, n1, h), cuda)
    want = rdma.SymmetricBuffer.local(P, (2, C, np0, n1, h), cuda)
    before = rdma.LAUNCHES["peer_ifft_x"]
    for my, (xr, xi) in enumerate(xs):
        rdma.ifft_x_push(xr, xi, got, my)
        rdma.ifft_x_push_ref(xr, xi, want, my)
    assert rdma.LAUNCHES["peer_ifft_x"] == before + P
    for g, w in zip(got.tensors, want.tensors):
        _close((g[0], g[1]), (w[0], w[1]))


def test_peer_fft_x_round_trip_is_identity(cuda):
    P, C, n0, n1, h = 4, 2, 256, 32, 64
    buf = rdma.SymmetricBuffer.local(P, (2, C, n0 // P, n1, h), cuda)
    orig = [_f32(t.shape, cuda, 60 + r) for r, t in enumerate(buf.tensors)]
    for t, o in zip(buf.tensors, orig):
        t.copy_(o)
    spec = [rdma.fft_x_pull(buf, my) for my in range(P)]
    torch.cuda.synchronize()
    for my, s in enumerate(spec):
        rdma.ifft_x_push(s[0].contiguous(), s[1].contiguous(), buf, my)
    _close(tuple(buf.tensors), tuple(orig))


def test_rdma_raises_without_ipc(cuda, monkeypatch, tmp_path):
    """communication='rdma' on the card never reroutes: a peer whose
    buffer cannot be opened raises, and no all_to_all_single runs."""
    import torch.distributed as dist
    from mpifft4py_tpu_torch.parallel import collectives
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        def refuse(handle):
            raise RuntimeError("cudaIpcOpenMemHandle: invalid context")

        def gather_fake(objs, obj, group=None):
            objs[0], objs[1] = obj, obj

        def no_reroute(*a, **k):
            raise AssertionError("rdma rerouted through all_to_all_single")
        monkeypatch.setattr(rdma, "_open_handle", refuse)
        monkeypatch.setattr(dist, "all_gather_object", gather_fake)
        monkeypatch.setattr(collectives, "transpose", no_reroute)
        monkeypatch.setattr(dist, "all_to_all_single", no_reroute)
        peers = rdma.PeerGroup(dist.group.WORLD, 2, 0, cuda)
        y = _f32((8, 16, 4), cuda)
        with pytest.raises(RuntimeError, match="rdma"):
            rdma.fused_transpose_fft_x(y, y.clone(), peers)
        with pytest.raises(RuntimeError, match="rdma"):
            rdma.rdma_all_to_all((y, y), peers, 1, 0)
    finally:
        dist.destroy_process_group()


# -- rows 26-27: the pencil's P2 transpose with the y c2c -----------------------

@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("C,n0,n1,w2", [(1, 128, 256, 65), (3, 8, 256, 33),
                                        (1, 4, 40, 5), (2, 6, 640, 7)])
def test_peer_fft_y_kernels_match_twins(cuda, P, C, n0, n1, w2):
    W, n1loc = P * w2, n1 // P
    pull = rdma.SymmetricBuffer.local(P, (2, C, n0, n1loc, W), cuda)
    for r, t in enumerate(pull.tensors):
        t.copy_(_f32(t.shape, cuda, 70 + r))
    before = rdma.LAUNCHES["peer_fft_y"]
    for my in range(P):
        got = rdma.fft_y_pull(pull, my)
        _close((got[0], got[1]), tuple(rdma.fft_y_pull_ref(pull, my)))
    assert rdma.LAUNCHES["peer_fft_y"] == before + P
    xs = [(_f32((C, n0, n1, w2), cuda, 80 + r),
           _f32((C, n0, n1, w2), cuda, 90 + r)) for r in range(P)]
    got = rdma.SymmetricBuffer.local(P, (2, C, n0, n1loc, W), cuda)
    want = rdma.SymmetricBuffer.local(P, (2, C, n0, n1loc, W), cuda)
    before = rdma.LAUNCHES["peer_ifft_y"]
    for my, (xr, xi) in enumerate(xs):
        rdma.ifft_y_push(xr, xi, got, my)
        rdma.ifft_y_push_ref(xr, xi, want, my)
    assert rdma.LAUNCHES["peer_ifft_y"] == before + P
    for g, w in zip(got.tensors, want.tensors):
        _close((g[0], g[1]), (w[0], w[1]))


def test_peer_fft_y_round_trip_and_out(cuda):
    """Row 26 into a given pair (the x stage's buffer), then row 27 back."""
    P, C, n0, n1, w2 = 2, 1, 16, 256, 65
    buf = rdma.SymmetricBuffer.local(P, (2, C, n0, n1 // P, P * w2), cuda)
    orig = [_f32(t.shape, cuda, 100 + r) for r, t in enumerate(buf.tensors)]
    for t, o in zip(buf.tensors, orig):
        t.copy_(o)
    spec = []
    for my in range(P):
        out = torch.empty((2, C, n0, n1, w2), device=cuda)
        got = rdma.fft_y_pull(buf, my, out=(out[0], out[1]))
        assert got[0].data_ptr() == out[0].data_ptr()
        spec.append(out)
    torch.cuda.synchronize()
    for my, s in enumerate(spec):
        rdma.ifft_y_push(s[0], s[1], buf, my)
    _close(tuple(buf.tensors), tuple(orig))


@pytest.mark.parametrize("n,nf,width", [(256, 129, 130), (256, 129, 132),
                                        (384, 129, 130), (32, 17, 20)])
def test_planar_rfft_pitch_matches_twin(cuda, n, nf, width):
    """Row 8 into ``width`` >= nf columns (zeros beyond nf: the pencil's
    alignment lanes) and row 9 back from the first nf of them."""
    x = _f32((3, 8, n), cuda, 7)
    scale = 1 / 1.5 ** 3 if n == 384 else 1.0
    got = p3.rfft_last_planar(x, nf, scale, width=width)
    _close(got, p3.rfft_last_planar_ref(x, nf, scale, width))
    assert float(got[0][..., nf:].abs().max()) == 0.0
    yr, yi = got[0] + 1.0, got[1] - 1.0       # garbage in the pad lanes
    yr[..., nf:], yi[..., nf:] = 7.0, 7.0
    back = p3.irfft_last_planar(yr, yi, n, nf_in=nf)
    _close(back, p3.irfft_last_planar_ref(yr[..., :nf].contiguous(),
                                          yi[..., :nf].contiguous(), n, nf))


def test_pencil_p1_on_the_card_matches_float64(cuda):
    """A 1×1 pencil on the card (the planar path: rows 8-9 and 1) against
    float64 torch.fft, the round trip, and its 3/2 forward against the
    slab's."""
    from mpifft4py_tpu_torch import pencil
    N, L = np.array([64, 48, 80]), np.array([2 * np.pi] * 3)
    F = pencil.R2C(N, L, None, "single", device=cuda)
    u = _f32(tuple(N), cuda, 3)
    fu = F.fftn(u)
    _close(fu, torch.fft.rfftn(u.double()).to(fu.dtype))
    _close(F.ifftn(fu), u)
    u3 = _f32((96, 72, 120), cuda, 4)
    S = R2C(N, L, None, "single", device=cuda)
    _close(F.fftn(u3, dealias="3/2-rule"), S.fftn(u3, dealias="3/2-rule"))


# the complex layout's pointwise right-hand side (csrc/rhs_pointwise.cu):
# a ragged stack, an odd plane (the one-value path), the 512^3 state, and
# each stack one value into a larger buffer (off the 16-byte grid)
RHS_COMPLEX = [((3, 24, 20, 13), 0), ((3, 5, 3, 7), 0),
               ((3, 512, 512, 257), 0), ((3, 24, 20, 13), 1)]
RHS_REAL = [((3, 24, 20, 13), 0), ((3, 5, 3, 7), 0), ((3, 512, 512, 512), 0),
            ((3, 8, 768, 768), 0), ((3, 24, 20, 16), 1)]


def _rhs_close(got, ref):
    """Within 1e-6 of max |twin| (the kernels round as the eager chain
    does, the projection's quotient but for its last bit)."""
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def _rhs_field(shape, off, dtype, device, seed):
    """A seeded contiguous stack of ``shape``, ``off`` values into its own
    buffer."""
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn(int(np.prod(shape)) + off, generator=g, dtype=dtype,
                    device=device)
    return x[off:].view(shape)


def _rhs_kvecs(shape, device):
    """The complex layout's scaled 1-D wavenumbers of (N0, N1, nf)."""
    n0, n1, nf = shape
    k = (np.fft.fftfreq(n0, 1 / n0), 0.5 * np.fft.fftfreq(n1, 1 / n1),
         2.0 * np.arange(nf))
    return tuple(torch.as_tensor(v.astype(np.float32), device=device)
                 for v in k)


@pytest.mark.parametrize("shape,off", RHS_COMPLEX)
def test_rhs_curl_matches_twin(cuda, shape, off):
    u = _rhs_field(shape, off, torch.complex64, cuda, 1)
    k = _rhs_kvecs(shape[1:], cuda)
    before = p3.LAUNCHES["rhs_curl"]
    got = p3.rhs_curl(u, *k)
    assert p3.LAUNCHES["rhs_curl"] == before + 1
    _rhs_close(got, p3.rhs_curl_ref(u, *k))


@pytest.mark.parametrize("shape,off", RHS_REAL)
def test_rhs_cross_matches_twin(cuda, shape, off):
    a = _rhs_field(shape, off, torch.float32, cuda, 1)
    b = _rhs_field(shape, off, torch.float32, cuda, 2)
    before = p3.LAUNCHES["rhs_cross"]
    got = p3.rhs_cross(a, b)
    assert p3.LAUNCHES["rhs_cross"] == before + 1
    _rhs_close(got, p3.rhs_cross_ref(a, b))


@pytest.mark.parametrize("shape,off", RHS_COMPLEX)
def test_rhs_leray_visc_matches_twin(cuda, shape, off):
    f = _rhs_field(shape, off, torch.complex64, cuda, 1)
    u = _rhs_field(shape, off, torch.complex64, cuda, 3)
    k = _rhs_kvecs(shape[1:], cuda)
    before = p3.LAUNCHES["rhs_leray_visc"]
    got = p3.rhs_leray_visc(f, u, *k, 0.000625)
    assert p3.LAUNCHES["rhs_leray_visc"] == before + 1
    _rhs_close(got, p3.rhs_leray_visc_ref(f, u, *k, 0.000625))


RHS_NAMES = ("rhs_curl", "rhs_cross", "rhs_leray_visc")


@pytest.mark.parametrize("dealias", ["2/3-rule", "3/2-rule"])
def test_complex_rhs_on_the_card_matches_twin_path(cuda, monkeypatch,
                                                   dealias):
    FFT = R2C(np.array([64, 64, 64]), np.array([2 * np.pi] * 3), None,
              "single", device=cuda)
    s = NavierStokes3D(FFT, nu=0.01, dt=0.01, dealias=dealias)
    U = s.taylor_green()
    U = U + 0.05 * _rhs_field(U.shape, 0, torch.complex64, cuda, 5) \
        * (U.abs().max() / 4)
    before = {n: p3.LAUNCHES[n] for n in RHS_NAMES}
    got = s.rhs_with_state(U)
    assert all(p3.LAUNCHES[n] == before[n] + 1 for n in RHS_NAMES)
    for n in RHS_NAMES:
        monkeypatch.setattr(p3, n, getattr(p3, n + "_ref"))
    _rhs_close(got, s.rhs_with_state(U))


def test_rhs_kernels_launch_four_times_a_complex_step_none_packed(cuda):
    FFT = R2C(np.array([32, 32, 256]), np.array([2 * np.pi] * 3), None,
              "single", device=cuda)
    for layout, want in (("complex", 4), ("packed", 0)):
        s = NavierStokes3D(FFT, nu=0.01, dt=0.01, spectral_layout=layout)
        U = s.taylor_green()
        before = {n: p3.LAUNCHES[n] for n in RHS_NAMES}
        s.step(U)
        assert {n: p3.LAUNCHES[n] - before[n] for n in RHS_NAMES} == \
            dict.fromkeys(RHS_NAMES, want)
