"""The port's pencil pieces that need no pool of ranks, against the JAX
package's.

* rows 26–27 (``fused_transpose_fft_y``/``fused_ifft_y_transpose``): the
  port's buffer-table twins (P ranks emulated in one process with
  ``SymmetricBuffer``) against the reference's Pallas kernels in interpret
  mode over P CPU devices, at P2 = 2 and 4, and the fused round trip;
* ``runtime.hybrid_mesh`` with given host lists (the cases of
  tests/test_runtime.py's fake devices) and ``mesh.pencil_groups`` in a
  world of one;
* ``pencil.R2C``/``C2C`` on a 1×1 grid against the reference's.

tests/test_torch_pencil_dist.py runs the P1×P2 grids over gloo ranks;
tests/test_torch_kernels_cuda.py and chip_smoke.py hold the CUDA kernels
of rows 26–27 against the twins on the card.  Tolerances: 1e-5 of max
|reference| for the peer twins (tests/test_rdma.py's own), 2e-6 for the
transforms (the slab tests' convention).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh, PartitionSpec as Ps

from mpifft4py_tpu import pencil as jpencil
from mpifft4py_tpu.parallel import rdma as jrdma
from mpifft4py_tpu_torch import pencil as tpencil
from mpifft4py_tpu_torch.parallel import mesh as tmesh
from mpifft4py_tpu_torch.parallel import rdma as trdma
from mpifft4py_tpu_torch.parallel import runtime as truntime
from test_torch_packed import _one_torch_thread  # noqa: F401

import torch

TAU = 2 * np.pi
L3 = np.array([TAU] * 3)


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


# -- rows 26-27: the buffer-table twins against the reference's kernels ----------

def _ref_y_kernels(yr, yi, P):
    """The reference's rows 26/27 in interpret mode over P devices: the
    global pair (n0, N1, W) cut along y into the forward, its result (cut
    along the lanes) into the inverse."""
    mesh = Mesh(np.array(jax.devices()[:P]), ("p",))
    sm = lambda f, i, o: jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=i, out_specs=o, check_vma=False))
    y, lanes = Ps(None, "p"), Ps(None, None, "p")
    with pltpu.force_tpu_interpret_mode():
        fwd = sm(lambda a, b: jrdma.fused_transpose_fft_y(
            a, b, "p", P, nchunks=2, interpret=True), (y, y), (lanes, lanes))(
            jnp.asarray(yr), jnp.asarray(yi))
        inv = sm(lambda a, b: jrdma.fused_ifft_y_transpose(
            a, b, "p", P, nchunks=2, interpret=True), (lanes, lanes),
            (y, y))(*fwd)
    return [np.asarray(v) for v in (*fwd, *inv)]


@pytest.mark.parametrize("P", [2, 4])
def test_peer_y_twins_match_reference_kernels(P):
    """Rows 26-27's twins at (n0, N1, W) = (4, 32, 9·P): an odd lane block
    of w2 = 9, as the pencil's Nfp/P2 is (65 at 256³ on 2×2)."""
    n0, n1, W = 4, 32, 9 * P
    g = np.random.default_rng(26)
    yr, yi = (g.standard_normal((n0, n1, W)).astype(np.float32)
              for _ in range(2))
    fr, fi, br, bi = _ref_y_kernels(yr, yi, P)
    n1loc, w2 = n1 // P, W // P
    pair = np.stack([yr, yi])[:, None]                 # (2, 1, n0, N1, W)
    buf = trdma.SymmetricBuffer([
        torch.from_numpy(pair[:, :, :, r * n1loc:(r + 1) * n1loc].copy())
        for r in range(P)])
    spec = [trdma.fft_y_pull(buf, r) for r in range(P)]
    _close(np.concatenate([s[0, 0].numpy() for s in spec], axis=-1), fr, 1e-5)
    _close(np.concatenate([s[1, 0].numpy() for s in spec], axis=-1), fi, 1e-5)
    assert all(tuple(s.shape) == (2, 1, n0, n1, w2) for s in spec)
    back = trdma.SymmetricBuffer.local(P, (2, 1, n0, n1loc, W), "cpu")
    for r, s in enumerate(spec):
        trdma.ifft_y_push(s[0].contiguous(), s[1].contiguous(), back, r)
    got = np.concatenate([t[:, 0].numpy() for t in back.tensors], axis=2)
    _close(got[0], br, 1e-5)
    _close(got[1], bi, 1e-5)
    _close(got, np.stack([yr, yi]), 1e-5)      # the fused round trip


def test_peer_y_refuses_bad_tables():
    buf = trdma.SymmetricBuffer.local(2, (2, 1, 4, 8, 9), "cpu")
    with pytest.raises(ValueError, match="divisible"):
        trdma.fft_y_pull(buf, 0)               # W = 9 lanes over 2 ranks
    buf = trdma.SymmetricBuffer.local(2, (2, 1, 4, 8, 10), "cpu")
    with pytest.raises(ValueError, match="rank"):
        trdma.fft_y_pull(buf, 2)
    with pytest.raises(ValueError, match="out"):
        trdma.fft_y_pull(buf, 0, out=(torch.zeros(1), torch.zeros(1)))


# -- the runtime's hybrid mesh and the pencil's groups in a world of one ----------

def test_hybrid_mesh_composition():
    """2 hosts x 4 ranks -> (2, 2, 2); the inner axes never cross a host."""
    hosts = [f"h{r // 4}" for r in range(8)]
    m = truntime.hybrid_mesh((2, 2), ("p1", "p2"), hosts=hosts)
    assert m.shape == (2, 2, 2)
    for g in range(2):
        assert {hosts[r] for r in m[g].ravel()} == {f"h{g}"}
    np.testing.assert_array_equal(m[0], [[0, 1], [2, 3]])


def test_hybrid_mesh_single_granule():
    m = truntime.hybrid_mesh((2, 2), ("p1", "p2"), hosts=["a"] * 4)
    assert m.shape == (1, 2, 2)
    np.testing.assert_array_equal(m[0], np.arange(4).reshape(2, 2))
    # this process alone: one host, one rank
    assert truntime.hybrid_mesh((1, 1), ("p1", "p2")).shape == (1, 1, 1)


@pytest.mark.parametrize("hosts,names", [
    (["a"] * 3 + ["b"] * 5, ("p1", "p2")),     # uneven granules
    (["a"] * 4, ("p1", "p2", "p3")),           # a wrong number of names
])
def test_hybrid_mesh_rejects(hosts, names):
    with pytest.raises(ValueError, match="granule|axis_names"):
        truntime.hybrid_mesh((2, 2), names, hosts=hosts)


def test_pencil_on_the_card_without_one_raises():
    """``device="cuda"`` (the default) without a card raises; it never
    turns into the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpencil.R2C(np.array([16, 16, 32]), L3, None, "single")


def test_pencil_groups_world_of_one():
    assert tmesh.pencil_groups() == (None, None, 1, 1, 0, 0)
    assert tmesh.pencil_groups(np.array([[0]]))[2:4] == (1, 1)
    with pytest.raises(ValueError, match="P1"):
        tmesh.pencil_groups(None, P1=2)
    with pytest.raises(ValueError, match="grid"):
        tmesh.pencil_groups(np.array([[0, 1]]))


# -- the 1×1 grid against the reference --------------------------------------------

@pytest.mark.parametrize("kind,dealias,alignment", [
    ("R2C", None, "X"), ("R2C", "2/3-rule", "Y"), ("R2C", "3/2-rule", "X"),
    ("C2C", None, "Y")])
def test_pencil_p1_matches_reference(kind, dealias, alignment):
    shape = (16, 16, 32)
    g = np.random.default_rng(5)
    work = tuple(int(1.5 * n) for n in shape) if dealias == "3/2-rule" \
        else shape
    u = g.standard_normal(work)
    if kind == "C2C":
        u = u + 1j * g.standard_normal(work)
    u = u.astype(np.float32 if kind == "R2C" else np.complex64)
    jcls, tcls = ((jpencil.R2C, tpencil.R2C) if kind == "R2C"
                  else (jpencil.C2C, tpencil.C2C))
    J = jcls(np.array(shape), L3, 1, "single", alignment=alignment)
    T = tcls(np.array(shape), L3, None, "single", alignment=alignment,
             device="cpu")
    ref = np.asarray(J.fftn(J.shard_real(u), dealias=dealias))
    fu = T.fftn(T.shard_real(u), dealias=dealias)
    _close(T.gather(fu), ref, 2e-6)
    _close(T.gather(T.ifftn(fu, dealias=dealias)),
           np.asarray(J.ifftn(J.shard_complex(ref), dealias=dealias)), 2e-6)
    assert T.global_complex_shape() == J.global_complex_shape()
    assert (T.P1, T.P2, T.Nf, T.Nfp) == (1, 1, J.Nf, J.Nfp)
