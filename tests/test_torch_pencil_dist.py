"""The port's pencil decomposition on P1×P2 grids against the JAX
package's.

The port's ranks are processes: one module-scoped pool of 4 gloo ranks
(``torch_dist_tasks.RankPool``, spawned, one intra-op torch thread each, a
``FileStore`` under the test's temporary directory) runs every case and
builds the 2×2, 4×1 and 1×4 grids from the same ranks.  The reference runs
in this process on the conftest's CPU devices at the same P1×P2
(``comm=4, P1=…``); its packed interface and WIDE choreography need
``MPIFFT4PY_TPU_PALLAS_DIST=force`` and its Pallas kernels in interpret
mode (``ref_pallas_dist``).  Inputs are made with numpy from a seed;
global arrays are compared (``gather`` on the port, rank 0's), so the
rank-to-block order only has to be self-consistent.

On the CPU, ``communication="rdma"`` runs the plain twins of rows 23–27
(the sub-groups' ``all_to_all_single`` and ``fft_axis_planar_ref``).

Tolerances (max-relative: the error's maximum over the maximum
|reference|): 2e-6 for transforms against the reference and float64
numpy (the slab tests' convention), 1e-5 for the packed interface and the
nonlinear forward (tests/test_torch_slab_dist.py's), NS3D steps at 2e-5
rel L2 against the reference's steps (float32 FFTs through different
libraries over 20 right-hand sides) and 1e-6 against the port's own
P == 1 steps.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mpifft4py_tpu import pencil as jpencil
from mpifft4py_tpu.models.navier_stokes import NavierStokes3D as JNS
from mpifft4py_tpu_torch import pencil as tpencil
from mpifft4py_tpu_torch import slab as tslab
from mpifft4py_tpu_torch.models import NavierStokes3D as TNS
from mpifft4py_tpu_torch.models.diagnostics import (
    dissipation, dissipation_packed, energy_spectrum, energy_spectrum_packed)
from mpifft4py_tpu_torch.utils import spectral
from mpifft4py_tpu_torch.utils.transfer import state_from_reference
from test_torch_packed import _one_torch_thread  # noqa: F401
from torch_dist_tasks import RankPool

import torch

TAU = 2 * np.pi
L3 = np.array([TAU] * 3)
TOL = 2e-6
SHAPE = (16, 16, 32)          # complex-layout and transform cases
PSHAPE = (16, 16, 256)        # the packed envelope: (N2/2) % 128 == 0


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, str(tmp_path_factory.mktemp("gloo4") / "store"))
    yield p
    p.close()


@pytest.fixture
def ref_pallas_dist(monkeypatch):
    """The reference's packed distributed paths off the TPU, its Pallas
    kernels in interpret mode (pencil.py:260-278)."""
    monkeypatch.setenv("MPIFFT4PY_TPU_PALLAS_DIST", "force")
    with pltpu.force_tpu_interpret_mode():
        yield


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def _rel_l2(got, ref):
    return np.linalg.norm(np.asarray(got) - ref) / np.linalg.norm(ref)


def _jfft(kind, shape, precision, P1, alignment="X"):
    cls = jpencil.R2C if kind == "R2C" else jpencil.C2C
    return cls(np.array(shape), L3, 4, precision, P1=P1, alignment=alignment)


# -- 1. the grid's sub-groups -------------------------------------------------------

def _case_grids(case):
    """Each rank's (P1, P2) grid of global ranks in a ``_grid_case`` of
    tests/torch_dist_tasks.py."""
    if case == "permuted":
        return [np.arange(4)[::-1].reshape(2, 2)] * 4
    if case in ("hosts2x1", "hosts1x2"):
        ici, hosts = (((2, 1), "baba") if case == "hosts2x1"
                      else ((1, 2), "aabb"))
        mesh = [np.array([r for r, h in enumerate(hosts) if h == g]
                         ).reshape(ici) for g in sorted(set(hosts))]
        return [next(m for m in mesh if r in m) for r in range(4)]
    p1 = 2 if case in (None, "hybrid") else case
    return [np.arange(4).reshape(p1, 4 // p1)] * 4


@pytest.mark.parametrize("case", [2, 4, 1, None, "hybrid", "permuted",
                                  "hosts2x1", "hosts1x2"])
def test_pencil_groups_layout(pool, case):
    """(r1, r2) is the rank's place in its grid; the P1 group is its grid
    column, the P2 group its row (None where it has one rank), the grid's
    group all of it, each in the grid's order; P1=None is the most square
    factor; the one-host slice of ``hybrid_mesh`` is a comm, also with two
    hosts, each building its own grid (mesh[0] and mesh[1]) at once."""
    for rank, (got, grid) in enumerate(zip(
            pool.run("pencil_groups_layout", case), _case_grids(case))):
        p1, p2 = grid.shape
        r1, r2 = (int(i) for i in np.argwhere(grid == rank)[0])
        assert got[:4] == (p1, p2, r1, r2)
        col, row, whole = got[4]
        assert col == (None if p1 == 1 else grid[:, r2].tolist())
        assert row == (None if p2 == 1 else grid[r1, :].tolist())
        assert whole == grid.ravel().tolist()


@pytest.mark.parametrize("communication", ["alltoall", "rdma"])
@pytest.mark.parametrize("case", ["permuted", "hosts2x1", "hosts1x2"])
def test_r2c_on_given_grids(pool, case, communication):
    """R2C on a permuted 2×2 grid and on each host's slice of a two-host
    ``hybrid_mesh`` (each host's pencil over its own ranks only): forward
    against float64 numpy (the alignment lanes 0) and the round trip."""
    u = np.random.default_rng(13).standard_normal(SHAPE).astype(np.float32)
    ref = np.fft.rfftn(u.astype(np.float64))
    nf = ref.shape[-1]
    for (fu, ub, grid), want in zip(
            pool.run("pencil_on_grid", case, SHAPE, communication, u),
            _case_grids(case)):
        assert grid == want.shape
        _close(fu[..., :nf], ref, TOL)
        assert not fu[..., nf:].any()
        _close(ub, u, TOL)


# -- 2. pencil.R2C / C2C ---------------------------------------------------------------

_REF = {}


def _field(kind, precision, dealias, seed=11):
    shape = (tuple(int(1.5 * n) for n in SHAPE) if dealias == "3/2-rule"
             else SHAPE)
    g = np.random.default_rng(seed)
    u = g.standard_normal(shape)
    if kind == "C2C":
        u = u + 1j * g.standard_normal(shape)
    return u.astype({("R2C", "single"): np.float32,
                     ("R2C", "double"): np.float64,
                     ("C2C", "single"): np.complex64,
                     ("C2C", "double"): np.complex128}[kind, precision])


def _ref_transform(kind, precision, P1, alignment, dealias, u):
    """The reference's gathered forward and round trip on its P1×P2 grid,
    and its local slices of every (r1, r2), cached per case."""
    key = (kind, precision, P1, alignment, dealias)
    if key not in _REF:
        J = _jfft(kind, SHAPE, precision, P1, alignment)
        fu = J.fftn(J.shard_real(u), dealias=dealias)
        ub = J.ifftn(fu, dealias=dealias)
        coords = [divmod(r, 4 // P1) for r in range(4)]
        _REF[key] = (np.asarray(fu), np.asarray(ub),
                     [J.real_local_slice(c) for c in coords],
                     [J.complex_local_slice(c) for c in coords], J.Nf)
    return _REF[key]


def _check_transform(pool, kind, precision, communication, P1, alignment,
                     dealias):
    u = _field(kind, precision, dealias)
    ref_fu, ref_ub, rsl, csl, nf = _ref_transform(kind, precision, P1,
                                                  alignment, dealias, u)
    res = pool.run("pencil_transform", kind, SHAPE, precision, communication,
                   P1, alignment, dealias, u)
    fu, ub = res[0][0], res[0][1]
    _close(fu, ref_fu, TOL)
    _close(ub, ref_ub, TOL)
    assert np.all(fu[..., nf:] == 0)       # the alignment lanes stay zero
    if dealias is None:
        ref = (np.fft.rfftn(u.astype(np.float64)) if kind == "R2C"
               else np.fft.fftn(u.astype(np.complex128)))
        _close(fu[..., :nf], ref, TOL)
        _close(ub, u, TOL)
    for r, (_, _, rs, cs, rshape, cshape, fshape, ushape) in enumerate(res):
        assert rs == rsl[r] and cs == csl[r]
        assert fshape == cshape
        assert ushape == tuple(s.stop - s.start for s in
                               (rs if dealias != "3/2-rule" else
                                _slices_padded(rs, P1)))


def _slices_padded(rs, P1):
    """The padded grid's block of the rank whose unpadded block is rs."""
    n0, n1 = (int(1.5 * n) for n in SHAPE[:2])
    r1 = rs[0].start // (SHAPE[0] // P1)
    r2 = rs[1].start // (SHAPE[1] // (4 // P1))
    b0, b1 = n0 // P1, n1 // (4 // P1)
    return (slice(r1 * b0, (r1 + 1) * b0), slice(r2 * b1, (r2 + 1) * b1),
            slice(0, int(1.5 * SHAPE[2])))


@pytest.mark.parametrize("precision", ["single", "double"])
@pytest.mark.parametrize("communication", ["alltoall", "pipelined", "rdma"])
@pytest.mark.parametrize("dealias", [None, "2/3-rule", "3/2-rule"])
def test_r2c_2x2_matches_reference(pool, dealias, communication, precision):
    if communication == "rdma" and precision == "double":
        # the torch.fft route moves complex128: rdma refuses, as the
        # reference does
        u = _field("R2C", precision, dealias)
        name, msg = pool.run("pencil_expect_raise", "R2C", SHAPE, precision,
                             communication, 2, "X", dealias, u)[0]
        assert name == "ValueError" and "rdma" in msg
        return
    _check_transform(pool, "R2C", precision, communication, 2, "X", dealias)


@pytest.mark.parametrize("communication", ["alltoall", "rdma"])
@pytest.mark.parametrize("dealias", [None, "3/2-rule"])
def test_r2c_2x2_alignment_y_matches_reference(pool, dealias, communication):
    _check_transform(pool, "R2C", "single", communication, 2, "Y", dealias)


@pytest.mark.parametrize("alignment", ["X", "Y"])
def test_c2c_2x2_matches_reference(pool, alignment):
    _check_transform(pool, "C2C", "single", "rdma", 2, alignment, None)


@pytest.mark.parametrize("P1", [4, 1])
def test_r2c_4x1_and_1x4_match_reference(pool, P1):
    """4×1 (the P2 transpose vanishes) and 1×4 (rows 26-27 over all four
    ranks, Nfp = 20, w2 = 5) under rdma."""
    _check_transform(pool, "R2C", "single", "rdma", P1, "X", None)


@pytest.mark.parametrize("P1,alignment", [(2, "X"), (2, "Y"), (1, "X")])
def test_meshes_match_reference(pool, P1, alignment):
    """The wavenumber mesh, the scaled mesh, the dealias filter and the
    physical mesh, gathered."""
    J = _jfft("R2C", SHAPE, "single", P1, alignment)
    K, Ks, filt, X = pool.run("pencil_meshes", SHAPE, P1, alignment)[0]
    np.testing.assert_array_equal(K, np.asarray(J.get_local_wavenumbermesh()))
    _close(Ks, np.asarray(J.get_scaled_local_wavenumbermesh()), 1e-7)
    np.testing.assert_array_equal(filt.astype(bool),
                                  np.asarray(J.get_dealias_filter()))
    _close(X, np.asarray(J.get_local_mesh()), 1e-7)


def test_divisibility_errors_match_reference(pool):
    """The reference's divisibility checks: C2C needs P2 | N2, and a P1
    that does not divide P raises."""
    u = _field("C2C", "single", None)
    shape = (16, 16, 18)
    with pytest.raises(ValueError, match="P2 \\| N2"):
        _jfft("C2C", shape, "single", 1)
    name, msg = pool.run("pencil_expect_raise", "C2C", shape, "single",
                         "alltoall", 1, "X", None, u[..., :18])[0]
    assert name == "ValueError" and "P2 | N2" in msg
    name, msg = pool.run("pencil_expect_raise", "R2C", SHAPE, "single",
                         "alltoall", 3, "X", None, u.real)[0]
    assert name == "ValueError" and "P1=3" in msg


# -- 3. the packed interface and the nonlinear forward --------------------------------

@pytest.mark.parametrize("P1,communication", [(2, "rdma"), (4, "rdma"),
                                              (2, "alltoall")])
def test_packed_interface_matches_reference(pool, ref_pallas_dist, P1,
                                            communication):
    """WIDE at 2×2 and the collapse at 4×1 (the slab's pipeline over the
    P1 group), 2/3 rule, a 3-stack."""
    J = _jfft("R2C", PSHAPE, "single", P1)
    assert J._packed_iface_ok("2/3-rule")
    key = ("packed", P1)
    U = np.random.default_rng(21).standard_normal(
        (3,) + PSHAPE).astype(np.float32)
    if key not in _REF:
        rr, ri = jax.jit(J.forward_packed_fn("2/3-rule"))(jnp.asarray(U))
        back = jax.jit(J.backward_packed_fn("2/3-rule"))((rr, ri))
        _REF[key] = [np.asarray(v) for v in (rr, ri, back)]
    got = pool.run("pencil_packed", PSHAPE, communication, P1, "2/3-rule",
                   U)[0]
    for g, r in zip(got, _REF[key]):
        _close(g, r, 1e-5)


@pytest.mark.parametrize("mode,op", [("project", "cross"), ("curl", "cross2")])
def test_nl_forward_epilogue_wide_matches_reference(pool, ref_pallas_dist,
                                                    mode, op):
    J = _jfft("R2C", PSHAPE, "single", 2)
    g = np.random.default_rng(31)
    h = PSHAPE[2] // 2
    phys = [g.standard_normal((3,) + PSHAPE).astype(np.float32)
            for _ in range(4 if op == "cross2" else 2)]
    Sr, Si = (g.standard_normal((3,) + PSHAPE[:2] + (h,)).astype(np.float32)
              for _ in range(2))
    kv = [k.numpy() for k in spectral.factored_wavenumbers(PSHAPE, L3, h)]
    mv = [m.numpy() for m in spectral.packed_dealias_masks(PSHAPE)]
    fn = J.nl_forward_epilogue_fn(mode, 0.01, op=op)
    dr, di = jax.jit(fn)(*(jnp.asarray(a) for a in phys + [Sr, Si]),
                         *(jnp.asarray(v) for v in kv + mv))
    got = pool.run("pencil_nl_epilogue", PSHAPE, "rdma", 2, phys, Sr, Si,
                   mode, op, 0.01)[0]
    _close(got[0], dr, 1e-5)
    _close(got[1], di, 1e-5)


# -- 4. NS3D on the 2×2 pencil ----------------------------------------------------------

def _ns_state(shape, seed=7):
    """Taylor–Green plus a seeded perturbation, 2/3-rule masked, complex64
    (the reference's P == 1 slab solver builds it)."""
    from mpifft4py_tpu import slab as jslab
    J = JNS(jslab.R2C(np.array(shape), L3, 1, "single"), nu=0.01, dt=0.01)
    U = np.asarray(J.taylor_green())
    p = np.fft.rfftn(np.random.default_rng(seed).standard_normal(
        (3,) + shape), axes=(1, 2, 3))
    U = U + 0.05 * p / np.abs(p).max() * np.abs(U).max()
    return (U * np.asarray(J.FFT.get_dealias_filter())).astype(np.complex64)


@pytest.mark.parametrize("layout", ["complex", "packed"])
def test_ns3d_rk4_2x2_matches_reference(pool, layout):
    """5 RK4 steps on the 2×2 pencil (packed: WIDE) under rdma against the
    reference's complex steps on its 2×2 pencil (2e-5 rel L2) and the
    port's own P == 1 steps (1e-6: the 1×1 pencil for the complex layout,
    the same planar arithmetic; the slab's packed steps for WIDE)."""
    shape = SHAPE if layout == "complex" else PSHAPE
    kw = dict(nu=0.0005 if layout == "packed" else 0.01,
              dt=0.001 if layout == "packed" else 0.01)
    U = _ns_state(shape)
    nf = shape[2] // 2 + 1
    J = JNS(_jfft("R2C", shape, "single", 2), dealias="2/3-rule", **kw)
    J._step_args()          # the wavenumbers outside the trace
    step = jax.jit(J.step)
    nfp = J.FFT.Nfp
    sj = jnp.asarray(np.pad(U, [(0, 0)] * 3 + [(0, nfp - nf)]))
    for _ in range(5):
        sj = step(sj)
    sj = np.asarray(sj)
    if layout == "packed":
        F1 = tslab.R2C(np.array(shape), L3, None, "single", device="cpu")
        T1 = TNS(F1, spectral_layout="packed", **kw)
        state = T1.to_packed(state_from_reference(U, F1))
        S1 = T1.run(state, 5)
        diag1 = (energy_spectrum_packed(F1, S1),
                 dissipation_packed(F1, S1, kw["nu"]))
        state = state.numpy()
    else:
        F1 = tpencil.R2C(np.array(shape), L3, None, "single", device="cpu")
        S1 = TNS(F1, **kw).run(state_from_reference(U, F1), 5)
        diag1 = energy_spectrum(F1, S1), dissipation(F1, S1, kw["nu"])
        state = np.pad(U, [(0, 0)] * 3 + [(0, nfp - nf)])
    s1 = S1.numpy()
    got, e, mon, spec, eps = pool.run("pencil_ns3d_steps", shape, layout,
                                      "rdma", 2, state, 5, kw["nu"],
                                      kw["dt"])[0]
    assert _rel_l2(got[..., :s1.shape[-1]], s1) <= 1e-6
    # the diagnostics and the Parseval monitor (the alignment lanes weigh
    # 0) against the P == 1 run and the physical energy
    _close(spec, diag1[0], 1e-6)
    assert abs(eps - diag1[1]) <= 1e-6 * abs(diag1[1])
    assert abs(mon - e) <= 1e-6 * e
    if layout == "packed":
        full = T1.from_packed(torch.from_numpy(got)).numpy()
        assert _rel_l2(full, sj[..., :nf]) <= 2e-5
    else:
        assert _rel_l2(got, sj) <= 2e-5
        full = got[..., :nf]
    u = np.fft.irfftn(full.astype(np.complex128), s=shape, axes=(1, 2, 3))
    e64 = 0.5 * np.mean(np.sum(u * u, axis=0))
    assert abs(e - e64) <= 1e-6 * e64
    u0 = np.fft.irfftn(U.astype(np.complex128), s=shape, axes=(1, 2, 3))
    assert e < 0.5 * np.mean(np.sum(u0 * u0, axis=0))


@pytest.mark.slow
def test_ns3d_wide_steps_match_reference_wide(pool, ref_pallas_dist):
    """2 RK4 steps of the port's WIDE packed layout on the 2×2 pencil under
    rdma against the reference's packed steps on its 2×2 pencil (rows 4/5,
    the P2 stage, the joint stage and the wide purify; its Pallas kernels
    in interpret mode take ~8 s a step here, hence 2 steps), both unpacked
    to the complex layout: 2e-5 rel L2.  It is ``slow`` because the
    reference's interpret-mode packed steps take 1.5–3.5 minutes on the
    CPU (alone, and among six xdist workers); the port's call it makes
    (``pencil_ns3d_steps`` on PSHAPE, "packed", "rdma", P1 = 2, the same
    state, ν and dt) is checked in every run by
    ``test_ns3d_rk4_2x2_matches_reference[packed]``."""
    kw = dict(nu=0.0005, dt=0.001)
    U = _ns_state(PSHAPE)
    JW = JNS(_jfft("R2C", PSHAPE, "single", 2), dealias="2/3-rule",
             spectral_layout="packed", **kw)
    one, args = JW._step_builder(), JW._step_args()
    pad = [(0, 0)] * 3 + [(0, JW.FFT.Nfp - JW.FFT.Nf)]
    sj = jax.jit(lambda s, *a: jax.lax.fori_loop(
        0, 2, lambda i, v: one(v, *a), s))(
        JW.to_packed(jnp.asarray(np.pad(U, pad))), *args)
    ref = np.asarray(JW.from_packed(sj))
    F1 = tslab.R2C(np.array(PSHAPE), L3, None, "single", device="cpu")
    T1 = TNS(F1, spectral_layout="packed", **kw)
    state = T1.to_packed(state_from_reference(U, F1)).numpy()
    got = pool.run("pencil_ns3d_steps", PSHAPE, "packed", "rdma", 2, state,
                   2, kw["nu"], kw["dt"])[0][0]
    full = T1.from_packed(torch.from_numpy(got)).numpy()
    assert _rel_l2(full, ref[..., :full.shape[-1]]) <= 2e-5
