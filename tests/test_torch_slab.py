"""The port's slab.R2C (mpifft4py_tpu_torch.slab) against the JAX package's.

Both take the same numpy-seeded fields.  The reference runs its jnp.fft path
on the CPU; the port runs the kernel path's glue through the kernels' plain
twins in "single" and torch.fft in "double".  Tolerances, relative to the
largest reference value: 1e-5 in single, 1e-12 in double.
"""

import numpy as np
import pytest
import torch

from mpifft4py_tpu import slab as jslab
from mpifft4py_tpu.utils import spectral as jsp
from mpifft4py_tpu_torch import datatypes, work_arrays
from mpifft4py_tpu_torch import slab as tslab
from mpifft4py_tpu_torch.utils import spectral as tsp
from test_torch_packed import _one_torch_thread  # noqa: F401

TAU = 2 * np.pi
TOL = {"single": 1e-5, "double": 1e-12}
GRIDS = [(32, 32, 32), (16, 32, 64)]


def _pair(N, precision, L=None):
    L = np.array([TAU] * 3) if L is None else np.asarray(L)
    return (jslab.R2C(np.array(N), L, 1, precision),
            tslab.R2C(np.array(N), L, None, precision, device="cpu"))


def _close(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("dealias", [None, "2/3-rule"])
@pytest.mark.parametrize("precision", ["single", "double"])
@pytest.mark.parametrize("N", GRIDS)
def test_fftn_ifftn_match_reference(rng, N, precision, dealias):
    J, T = _pair(N, precision)
    u = rng.standard_normal(N)
    if precision == "single":
        assert T._kernel3d_ok()
        u = u.astype(np.float32)
    fj = J.fftn(u, dealias=dealias)
    ft = T.fftn(u, dealias=dealias)
    assert ft.dtype == T.complex and ft.device == T.device
    _close(ft, fj, TOL[precision])
    fu = np.fft.rfftn(rng.standard_normal(N)).astype(T.gather(ft).dtype)
    _close(T.ifftn(fu, dealias=dealias), J.ifftn(fu, dealias=dealias),
           TOL[precision])


@pytest.mark.parametrize("precision", ["single", "double"])
def test_batched_fields_match_reference(rng, precision):
    J, T = _pair((16, 32, 64), precision)
    U = rng.standard_normal((3, 16, 32, 64)).astype(
        np.float32 if precision == "single" else np.float64)
    FU = T.forward_fields_fn("2/3-rule")(T.shard_real(U))
    _close(FU, J.forward_fields_fn("2/3-rule")(J.shard_real(U)),
           TOL[precision])
    _close(T.backward_fields_fn()(FU),
           J.backward_fields_fn()(J.shard_complex(T.gather(FU))),
           TOL[precision])


def test_shape_helpers_match_reference():
    J, T = _pair((16, 32, 64), "single")
    for name in ("real_shape", "complex_shape", "complex_shape_T",
                 "complex_shape_I", "global_real_shape", "global_complex_shape",
                 "real_shape_padded", "global_real_shape_padded",
                 "real_local_slice", "complex_local_slice"):
        assert getattr(T, name)() == getattr(J, name)(), name
    for d in (None, "3/2-rule"):
        assert T.work_shape(d) == J.work_shape(d)
        assert T.global_work_shape(d) == J.global_work_shape(d)
    assert T.Nf == J.Nf == 33 and T.P == 1 and T.rank == 0


@pytest.mark.parametrize("precision", ["single", "double"])
def test_meshes_and_filter_match_reference(precision):
    L = [TAU, 2.0, 3.5]
    J, T = _pair((16, 32, 64), precision, L)
    tol = TOL[precision]
    _close(T.get_local_wavenumbermesh(), J.get_local_wavenumbermesh(), 0)
    _close(T.get_scaled_local_wavenumbermesh(),
           J.get_scaled_local_wavenumbermesh(), tol)
    _close(T.get_local_mesh(), J.get_local_mesh(), tol)
    assert (T.get_dealias_filter().numpy()
            == np.asarray(J.get_dealias_filter())).all()
    assert T.get_local_mesh().dtype == T.float


def test_kernel_gate_is_a_shape_predicate():
    def ok(N, precision="single"):
        return tslab.R2C(np.array(N), np.array([TAU] * 3), None, precision,
                         device="cpu")._kernel3d_ok()
    assert ok((16, 24, 32)) and ok((256, 256, 256)) and ok((48, 96, 1024))
    assert ok((18, 40, 2048)) and ok((8, 112, 1280))
    assert not ok((32, 32, 32), "double")
    assert not ok((262, 32, 32)) and not ok((32, 32, 2050))   # 262 = 2·131
    assert not ok((4, 32, 32))


def test_unported_options_raise():
    N, L = np.array([16] * 3), np.array([TAU] * 3)
    # an int comm names the group's size: a world of one is not 2 or 4
    with pytest.raises(ValueError, match="torch.distributed"):
        tslab.R2C(N, L, 2, "single", device="cpu")
    with pytest.raises(ValueError, match="torch.distributed"):
        tslab.C2C(N, L, 4, "single", device="cpu")
    # the family is ported at P == 1 only (P = 2 stands in for a group
    # here; tests/test_torch_slab_dist.py raises it on a real one)
    from mpifft4py_tpu_torch.models import VorticityVelocity3D
    FFT = tslab.R2C(N, L, None, "single", device="cpu")
    FFT.P = 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VorticityVelocity3D(FFT, 0.01, 0.01)
    with pytest.raises(ValueError):
        tslab.R2C(np.array([16, 16, 15]), L, None, "single", device="cpu")


def test_cuda_default_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tslab.R2C(np.array([16] * 3), np.array([TAU] * 3), None, "single")


def test_precision_policy_and_work_arrays():
    assert datatypes("single") == (torch.float32, torch.complex64,
                                   torch.complex64)
    assert datatypes("double")[:2] == (torch.float64, torch.complex128)
    with pytest.raises(ValueError):
        datatypes("quad")
    wa = work_arrays("cpu")
    a = wa[((4, 5), torch.complex64, 0)]
    assert a.shape == (4, 5) and a.dtype == torch.complex64
    assert wa[(a, 0)] is a and not a.abs().any()


@pytest.mark.parametrize("axis", [0, 1])
def test_spectral_helpers_match_reference(rng, axis):
    x = (rng.standard_normal((8, 12, 5))
         + 1j * rng.standard_normal((8, 12, 5)))
    t = torch.from_numpy(x)
    for tf, jf, arg in ((tsp.pad_full_axis, jsp.pad_full_axis, 16),
                        (tsp.trunc_full_axis, jsp.trunc_full_axis, 6)):
        _close(tf(t, axis, arg), jf(x, axis, arg), 1e-15)
    _close(tsp.pad_half_axis(t, 2, 9), jsp.pad_half_axis(x, 2, 9), 1e-15)
    _close(tsp.trunc_half_axis(t, 2, 3), jsp.trunc_half_axis(x, 2, 3), 1e-15)
    _close(tsp.flip_conj_plane(t[..., 0], (0, 1)),
           jsp.flip_conj_plane(x[..., 0], (0, 1)), 1e-15)
    assert (tsp.wavenumbers_full(8) == jsp.wavenumbers_full(8)).all()
    assert (tsp.dealias_cutoffs([16, 32, 64])
            == jsp.dealias_cutoffs([16, 32, 64])).all()
