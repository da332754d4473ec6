"""The port's slab decomposition at P > 1 against the JAX package's.

The port's ranks are processes: a module-scoped pool of 2 gloo ranks
(``torch_dist_tasks.RankPool``, spawned, one intra-op torch thread each,
a ``FileStore`` under the test's temporary directory) runs every case, and
one pool of 4 ranks runs the P = 4 case.  The reference runs in this
process on the conftest's 8-device CPU mesh at the same P, its Pallas
kernels in interpret mode.  Inputs are made with numpy from a seed and
handed to both; the port's ranks take their blocks of the global arrays and
``gather`` returns the global result on every rank (rank 0's is compared).

On the CPU, ``communication="rdma"`` runs the plain twins of rows 23-25
(the group's ``all_to_all_single`` and ``fft_axis_planar_ref``);
tests/test_torch_kernels_cuda.py and chip_smoke.py hold the kernels
against those twins on the card.

Tolerances: 2e-6 of max |reference| for transforms against the reference
and float64 numpy (tests/test_rdma.py:43-60); 1e-5 for the peer twins
against the reference's kernels (tests/test_rdma.py's own); NS3D steps at
2e-5 against the reference's steps (float32 FFTs through different
libraries over 8 right-hand sides, tests/test_torch_envelope.py) and 1e-6
against the port's own P == 1 step (the same arithmetic, transposed).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh, PartitionSpec as Ps

from mpifft4py_tpu import slab as jslab
from mpifft4py_tpu.models.navier_stokes import NavierStokes3D as JNS
from mpifft4py_tpu.ops import pallas_fft3d as jp3
from mpifft4py_tpu.parallel import rdma as jrdma
from mpifft4py_tpu_torch import slab as tslab
from mpifft4py_tpu_torch.models import NavierStokes3D as TNS
from mpifft4py_tpu_torch.parallel import rdma as trdma
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
    p = RankPool(2, str(tmp_path_factory.mktemp("gloo2") / "store"))
    yield p
    p.close()


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def _rng(seed=0):
    return np.random.default_rng(seed)


# -- 1. the collective transposes -----------------------------------------------

@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("split,concat", [(1, 0), (0, 1), (2, 0)])
def test_transpose_matches_block_transpose(pool, split, concat, pipelined):
    shape = (4, 6, 8)
    got = pool.run("transpose_blocks", shape, split, concat, pipelined)
    xs = [np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
          + 1e4 * r for r in range(2)]
    for r, g in enumerate(got):
        want = np.concatenate([np.split(x, 2, axis=split)[r] for x in xs],
                              axis=concat)
        np.testing.assert_array_equal(g, want * (2 if pipelined else 1))


# -- 2. the plain versions of rows 23-25 against the reference's kernels --------

def _ref_kernels(y, P):
    """The reference's rows 23/24/25 in interpret mode on the global pair
    y (2, N0, N1, h) over P devices: the all-to-all (1 → 0), the fused
    forward and the fused inverse of its result."""
    mesh = Mesh(np.array(jax.devices()[:P]), ("p",))
    sm = lambda f, i, o: jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=i, out_specs=o, check_vma=False))
    a, b = jnp.asarray(y[0]), jnp.asarray(y[1])
    with pltpu.force_tpu_interpret_mode():
        a2a = sm(lambda u: jrdma.rdma_all_to_all(u, "p", 1, 0, P,
                                                 interpret=True),
                 Ps("p"), Ps(None, "p"))(a)
        fwd = sm(lambda u, v: jrdma.fused_transpose_fft_x(
            u, v, "p", P, nchunks=2, interpret=True),
            (Ps("p"), Ps("p")), (Ps(None, "p"), Ps(None, "p")))(a, b)
        inv = sm(lambda u, v: jrdma.fused_ifft_x_transpose(
            u, v, "p", P, nchunks=2, interpret=True),
            (Ps(None, "p"), Ps(None, "p")), (Ps("p"), Ps("p")))(*fwd)
    return [np.asarray(v) for v in (a2a, *fwd, *inv)]


def test_peer_twins_match_reference_kernels():
    """The buffer-table twins (P ranks emulated in one process) against
    the reference's rows 23/24/25 at (16, 16, 256), P = 2."""
    P, (n0, n1, h) = 2, PSHAPE
    y = _rng(3).standard_normal((2,) + PSHAPE).astype(np.float32)
    a2a, fr, fi, br, bi = _ref_kernels(y, P)
    np0, np1 = n0 // P, n1 // P
    blocks = [torch.from_numpy(y[:, r * np0:(r + 1) * np0]) for r in range(P)]
    buf = trdma.SymmetricBuffer.local(P, (1, n0, np1, h), "cpu")
    for r in range(P):
        trdma.a2a_push_ref(blocks[r][0].contiguous(), buf, r, 1, 0)
    _close(np.concatenate([t[0].numpy() for t in buf.tensors], axis=1), a2a,
           1e-5)
    xb = trdma.SymmetricBuffer(
        [b.unsqueeze(1).contiguous() for b in blocks])   # (2, 1, np0, n1, h)
    spec = [trdma.fft_x_pull(xb, r) for r in range(P)]
    _close(np.concatenate([s[0, 0].numpy() for s in spec], axis=1), fr, 1e-5)
    _close(np.concatenate([s[1, 0].numpy() for s in spec], axis=1), fi, 1e-5)
    back = trdma.SymmetricBuffer.local(P, (2, 1, np0, n1, h), "cpu")
    for r, s in enumerate(spec):
        trdma.ifft_x_push(s[0].contiguous(), s[1].contiguous(), back, r)
    _close(np.concatenate([t[0, 0].numpy() for t in back.tensors]), br, 1e-5)
    _close(np.concatenate([t[1, 0].numpy() for t in back.tensors]), bi, 1e-5)


def test_peer_group_functions_plain(pool):
    """The group-level rdma functions on CPU tensors over the gloo ranks,
    against numpy: the all-to-all, the fused forward, its inverse."""
    shape = (8, 16, 6)
    got = pool.run("rdma_group_plain", shape, 5)
    g = _rng(5)
    yr, yi = (g.standard_normal(shape).astype(np.float32) for _ in range(2))
    spec = np.fft.fft((yr + 1j * yi).astype(np.complex128), axis=0)
    for r, (ar, ai, fr, fi, br, bi) in enumerate(got):
        cols = slice(r * 8, (r + 1) * 8)
        np.testing.assert_array_equal(ar, yr[:, cols])
        np.testing.assert_array_equal(ai, yi[:, cols])
        _close(fr + 1j * fi, spec[:, cols], TOL)
        _close(br, yr[r * 4:(r + 1) * 4], TOL)
        _close(bi, yi[r * 4:(r + 1) * 4], TOL)


# -- 3.-4. slab.R2C and slab.C2C at P = 2 ------------------------------------------

_REF = {}


def _ref_transform(kind, precision, dealias, u):
    """The reference's gathered forward and round trip at P = 2, and its
    local slices of rank 0 and 1."""
    key = (kind, precision, dealias)
    if key not in _REF:
        cls = jslab.R2C if kind == "R2C" else jslab.C2C
        J = cls(np.array(SHAPE), L3, 2, precision)
        fu = J.fftn(J.shard_real(u), dealias=dealias)
        ub = J.ifftn(fu, dealias=dealias)
        _REF[key] = (np.asarray(fu), np.asarray(ub),
                     [J.real_local_slice(r) for r in range(2)],
                     [J.complex_local_slice(r) for r in range(2)])
    return _REF[key]


def _field(kind, precision, dealias):
    shape = (tuple(int(1.5 * n) for n in SHAPE) if dealias == "3/2-rule"
             else SHAPE)
    g = _rng(11)
    u = g.standard_normal(shape)
    if kind == "C2C":
        u = u + 1j * g.standard_normal(shape)
    return u.astype({("R2C", "single"): np.float32,
                     ("R2C", "double"): np.float64,
                     ("C2C", "single"): np.complex64,
                     ("C2C", "double"): np.complex128}[kind, precision])


def _numpy_forward(kind, u):
    """The float64 numpy forward."""
    if kind == "R2C":
        return np.fft.rfftn(u.astype(np.float64))
    return np.fft.fftn(u.astype(np.complex128))


def _check_transform(pool, kind, precision, communication, dealias):
    u = _field(kind, precision, dealias)
    ref_fu, ref_ub, rsl, csl = _ref_transform(kind, precision, dealias, u)
    res = pool.run("slab_transform", kind, SHAPE, precision, communication,
                   dealias, u)
    fu, ub = res[0][0], res[0][1]
    _close(fu, ref_fu, TOL)
    _close(ub, ref_ub, TOL)
    if dealias is None:
        _close(fu, _numpy_forward(kind, u), TOL)
        _close(ub, u, TOL)
    for r, (_, _, rs, cs, rshape, cshape, fshape, ushape) in enumerate(res):
        assert rs == rsl[r] and cs == csl[r]
        assert fshape == cshape
        assert ushape == (tuple(s // 2 if i == 0 else s for i, s in
                                enumerate(u.shape)))


@pytest.mark.parametrize("precision", ["single", "double"])
@pytest.mark.parametrize("communication", ["alltoall", "pipelined", "rdma"])
@pytest.mark.parametrize("dealias", [None, "2/3-rule", "3/2-rule"])
def test_r2c_matches_reference(pool, dealias, communication, precision):
    if communication == "rdma" and precision == "double":
        # the torch.fft route moves complex128: rdma refuses (item 8)
        u = _field("R2C", precision, dealias)
        name, msg = pool.run("slab_expect_raise", "R2C", SHAPE, precision,
                             communication, dealias, u)[0]
        assert name == "ValueError" and "rdma" in msg
        return
    _check_transform(pool, "R2C", precision, communication, dealias)


@pytest.mark.parametrize("communication", ["alltoall", "rdma"])
@pytest.mark.parametrize("dealias", [None, "2/3-rule", "3/2-rule"])
def test_c2c_matches_reference(pool, dealias, communication):
    _check_transform(pool, "C2C", "single", communication, dealias)


def test_r2c_at_p4_matches_reference(tmp_path):
    """P = 4 (its own pool) under rdma: the forward, the 3/2 rule."""
    p4 = RankPool(4, str(tmp_path / "store"))
    try:
        for dealias in (None, "3/2-rule"):
            u = _field("R2C", "single", dealias)
            J = jslab.R2C(np.array(SHAPE), L3, 4, "single")
            ref = np.asarray(J.fftn(J.shard_real(u), dealias=dealias))
            res = p4.run("slab_transform", "R2C", SHAPE, "single", "rdma",
                         dealias, u)
            _close(res[0][0], ref, TOL)
            _close(res[3][1], np.asarray(J.ifftn(J.shard_complex(ref),
                                                 dealias=dealias)), TOL)
            assert [r[2] for r in res] == [J.real_local_slice(k)
                                           for k in range(4)]
    finally:
        p4.close()


# -- 5.-6. the packed interface and the nonlinear forward ------------------------

@pytest.fixture
def ref_pallas_dist(monkeypatch):
    """The reference's packed distributed path off the TPU, its Pallas
    kernels in interpret mode (slab.py:713-715)."""
    monkeypatch.setenv("MPIFFT4PY_TPU_PALLAS_DIST", "force")
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("communication", ["alltoall", "rdma"])
def test_packed_interface_matches_reference(pool, ref_pallas_dist,
                                            communication):
    J = jslab.R2C(np.array(PSHAPE), L3, 2, "single")
    assert J._pallas_dist_ok("2/3-rule")
    u = _rng(21).standard_normal(PSHAPE).astype(np.float32)
    if "packed" not in _REF:
        rr, ri = jax.jit(J.forward_packed_fn("2/3-rule"))(jnp.asarray(u))
        back = jax.jit(J.backward_packed_fn("2/3-rule"))((rr, ri))
        _REF["packed"] = [np.asarray(v) for v in (rr, ri, back)]
    got = pool.run("packed_interface", PSHAPE, communication, "2/3-rule", u)
    for g, r in zip(got[0], _REF["packed"]):
        _close(g, r, 1e-5)


@pytest.mark.parametrize("mode,op", [("project", "cross"),
                                     ("curl", "cross2"), ("div", "mul")])
def test_nl_forward_epilogue_matches_reference(pool, ref_pallas_dist, mode,
                                               op):
    J = jslab.R2C(np.array(PSHAPE), L3, 2, "single")
    g = _rng(31)
    h = PSHAPE[2] // 2
    ns = 1 if mode == "div" else 3
    phys = [g.standard_normal((3,) + PSHAPE).astype(np.float32)
            for _ in range(4 if op == "cross2" else 2)]
    if op == "mul":
        phys[1] = phys[1][:1]
    Sr, Si = (g.standard_normal((ns,) + PSHAPE[:2] + (h,))
              .astype(np.float32) for _ in range(2))
    from mpifft4py_tpu_torch.utils import spectral
    kv = [k.numpy() for k in spectral.factored_wavenumbers(PSHAPE, L3, h)]
    mv = [m.numpy() for m in spectral.packed_dealias_masks(PSHAPE)]
    fn = J.nl_forward_epilogue_fn(mode, 0.01, op=op)
    dr, di = jax.jit(fn)(*(jnp.asarray(a) for a in phys + [Sr, Si]),
                         *(jnp.asarray(v) for v in kv + mv))
    got = pool.run("nl_epilogue", PSHAPE, "rdma", phys, Sr, Si, mode,
                   op, 0.01)[0]
    _close(got[0], dr, 1e-5)
    _close(got[1], di, 1e-5)


# -- 7. NS3D at P = 2 ----------------------------------------------------------------

def _ns_state(shape, seed=7):
    """Taylor–Green plus a seeded perturbation, 2/3-rule masked, complex64
    (the reference's P == 1 solver builds it)."""
    J = JNS(jslab.R2C(np.array(shape), L3, 1, "single"), nu=0.01, dt=0.01)
    U = np.asarray(J.taylor_green())
    p = np.fft.rfftn(_rng(seed).standard_normal((3,) + shape), axes=(1, 2, 3))
    U = U + 0.05 * p / np.abs(p).max() * np.abs(U).max()
    return (U * np.asarray(J.FFT.get_dealias_filter())).astype(np.complex64)


def _energy64(U, shape):
    u = np.fft.irfftn(U.astype(np.complex128), s=shape, axes=(1, 2, 3))
    return 0.5 * np.mean(np.sum(u * u, axis=0))


@pytest.mark.parametrize("layout", ["complex", "packed"])
def test_ns3d_rk4_at_p2(pool, layout):
    shape = SHAPE if layout == "complex" else PSHAPE
    kw = dict(nu=0.0005 if layout == "packed" else 0.01,
              dt=0.001 if layout == "packed" else 0.01)
    U = _ns_state(shape)
    J = JNS(jslab.R2C(np.array(shape), L3, 2, "single"), dealias="2/3-rule",
            **kw)
    J._step_args()          # the wavenumbers outside the trace
    step = jax.jit(J.step)
    sj = jnp.asarray(U)
    for _ in range(2):
        sj = step(sj)
    sj = np.asarray(sj)
    F1 = tslab.R2C(np.array(shape), L3, None, "single", device="cpu")
    T1 = TNS(F1, spectral_layout=layout, **kw)
    s1 = state_from_reference(U, F1)
    if layout == "packed":
        s1 = T1.to_packed(s1)
    s1 = T1.run(s1, 2)
    state = (T1.to_packed(state_from_reference(U, F1)).numpy()
             if layout == "packed" else U)
    got, e = pool.run("ns3d_steps", shape, layout, "rdma", state, 2,
                      kw["nu"], kw["dt"])[0]
    _close(got, s1.numpy(), 1e-6)
    full = T1.from_packed(torch.from_numpy(got)).numpy() \
        if layout == "packed" else got
    _close(full, sj, 2e-5)
    assert abs(e - _energy64(full, shape)) <= 1e-6 * _energy64(full, shape)
    assert e < _energy64(U, shape)


@pytest.mark.parametrize("layout,integrator", [("complex", "LSRK54"),
                                               ("packed", "Euler"),
                                               ("complex", "AB2")])
def test_ns3d_forcing_integrators_diagnostics_at_p2(pool, layout,
                                                    integrator):
    """Band forcing (its energy norm all-reduced), the other integrators
    and the diagnostics (shell sums all-reduced) at P = 2 against the
    port's P == 1 run, 1e-6."""
    from mpifft4py_tpu_torch.models.diagnostics import (
        dissipation, dissipation_packed, energy_spectrum,
        energy_spectrum_packed)
    shape = SHAPE if layout == "complex" else PSHAPE
    kw = dict(nu=0.0005, dt=0.001, forcing_band=(1.0, 3.0),
              forcing_rate=0.1)
    U = _ns_state(shape)
    F1 = tslab.R2C(np.array(shape), L3, None, "single", device="cpu")
    T1 = TNS(F1, spectral_layout=layout, integrator=integrator, **kw)
    s1 = state_from_reference(U, F1)
    if layout == "packed":
        s1 = T1.to_packed(s1)
    state = s1.numpy()
    if integrator == "AB2":
        s1 = T1.ab2_state(s1)
    s1 = T1._carry_state(T1.run(s1, 2))
    if layout == "packed":
        spec, eps = (energy_spectrum_packed(F1, s1),
                     dissipation_packed(F1, s1, kw["nu"]))
    else:
        spec, eps = energy_spectrum(F1, s1), dissipation(F1, s1, kw["nu"])
    got, e, gspec, geps = pool.run("ns3d_forced", shape, layout, integrator,
                                   state, 2, kw)[0]
    _close(got, s1.numpy(), 1e-6)
    assert abs(e - T1.energy(s1)) <= 1e-6 * T1.energy(s1)
    _close(gspec, spec, 1e-6)
    assert abs(geps - eps) <= 1e-6 * abs(eps)


# -- 8. what raises at P > 1 -----------------------------------------------------------

def test_family_and_line_raise_at_p2(pool):
    for msg in pool.run("family_and_line_raise", SHAPE)[0]:
        assert msg is not None and "ROADMAP" in msg


def test_complex_leaf_under_rdma_raises(pool):
    """The torch.fft route (a grid outside the kernels' envelope: N2 = 10)
    moves complex64 spectra: rdma refuses them, as the reference does."""
    shape = (16, 16, 10)
    u = _rng(2).standard_normal(shape).astype(np.float32)
    name, msg = pool.run("slab_expect_raise", "R2C", shape, "single", "rdma",
                         None, u)[0]
    assert name == "ValueError" and "rdma" in msg
    assert not jp3.supported_r2c(10)


# -- 9. the benchmark's slab reference and its 4-card cell's entry, at P = 2 --

def _div_free_state(shape, seed, energy=0.05):
    """A seeded random divergence-free spectral state (3, N0, N1, Nf),
    complex128, 2/3-rule masked, of Parseval energy ``energy``."""
    n0, n1, n2 = shape
    U = np.fft.rfftn(_rng(seed).standard_normal((3,) + shape), axes=(1, 2, 3))
    k = (np.fft.fftfreq(n0, 1 / n0)[:, None, None],
         np.fft.fftfreq(n1, 1 / n1)[None, :, None],
         np.arange(n2 // 2 + 1)[None, None, :])
    ksq = k[0] ** 2 + k[1] ** 2 + k[2] ** 2
    div = sum(ki * Ui for ki, Ui in zip(k, U)) / np.where(ksq == 0, 1, ksq)
    U = np.stack([Ui - ki * div for ki, Ui in zip(k, U)])
    U *= ((np.abs(k[0]) < n0 / 3) & (np.abs(k[1]) < n1 / 3)
          & (k[2] < n2 / 3))
    w = np.where((k[2] == 0) | (k[2] == n2 // 2), 1.0, 2.0)
    e = 0.5 * np.sum(w * np.abs(U) ** 2) / float(np.prod(shape)) ** 2
    return U * np.sqrt(energy / e)


def _packed_pair(U):
    """The packed float32 pair of a Nyquist-free complex state."""
    h = U.shape[-1] - 1
    return (np.ascontiguousarray(U[..., :h].real, dtype=np.float32),
            np.ascontiguousarray(U[..., :h].imag, dtype=np.float32))


def test_ns3d_packed_matches_slab_reference_at_p2(pool):
    """The port's packed NS3D at P = 2 (alltoall) against the benchmark's
    float64 slab reference over the same ranks, 2 RK4 steps from a random
    divergence-free state: 2e-5 of max (float32 transforms over 8
    right-hand sides), and the slab conversion of the packed state equal to
    the one-process conversion."""
    U = _div_free_state(PSHAPE, 41)
    got = pool.run("ns3d_packed_vs_slab_reference", PSHAPE, _packed_pair(U),
                   2, 0.0005, 0.001)
    gap, top, conv = (max(r[i] for r in got) for i in range(3))
    assert gap <= 2e-5 * top
    assert conv <= 1e-7 * np.abs(U).max()


def test_slab_reference_matches_one_process_at_p2(pool):
    """The benchmark's float64 slab reference at P = 2 against its
    one-process NS3D: 2 RK4 steps from a random divergence-free state and
    the Taylor–Green state within 1e-12 of max, the energies alike."""
    U = _div_free_state(PSHAPE, 43)
    got = pool.run("ns3d_slab_vs_one_process", PSHAPE, U, 2, 0.0005, 0.001)
    top = max(r[2] for r in got)
    assert max(r[0] for r in got) <= 1e-12 * top
    assert max(r[1] for r in got) <= 1e-12 * np.prod(PSHAPE)
    e_slab, e_one = got[0][3], got[0][4]
    assert abs(e_slab - e_one) <= 1e-12 * e_one
    assert all(r[3] == e_slab for r in got)


def test_slab_entry_state_matches_one_process(pool):
    """The 4-card cell's entry at P = 2, each rank adding its k1 block of
    the seed's perturbation: its global initial state against the
    one-card entry's (``ns3d_run``) in one process."""
    import importlib.util
    import json
    import os
    import sys
    from torch_dist_tasks import BENCH
    if BENCH not in sys.path:
        sys.path.append(BENCH)
    with open(os.path.join(BENCH, "configs", "tgv1600_1024.json")) as f:
        cfg = dict(json.load(f), N=list(PSHAPE), P=2,
                   perturbation={"kmax": 2, "amplitude": 0.01})
    with open(os.path.join(BENCH, "traffic", "slab_p4.json")) as f:
        traffic = json.load(f)
    seed = 2 ** 31 + 2 ** 20 + 17
    got = pool.run("slab_entry_state", cfg, traffic, seed)[0]
    spec = importlib.util.spec_from_file_location(
        "entry_ns3d_run", os.path.join(BENCH, "entries", "ns3d_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want = mod.Entry(cfg, traffic, seed, "cpu").state.numpy()
    _close(got, want, 1e-6)
    # the perturbation is there, not only the vortex
    tg = mod.Entry(cfg, traffic, seed + 1, "cpu").state.numpy()
    assert np.abs(tg - want).max() > 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("communication,spans", [("alltoall", 1),
                                                  ("pipelined", 8)])
def test_exchange_counter_at_p2(pool, communication, spans):
    """The exchange span's byte counter over one packed RK4 step at P = 2:
    in each of 4 right-hand sides 3 transposes of a (re, im) pair of
    3-stacks, half of each leaving the rank, and one all-gather of plane
    k2 = 0's pair; none recorded with tracing off.  A transpose opens one
    span, a pipelined one (4 chunks) one around each chunk's post and one
    around each chunk's wait."""
    P, (n0, n1, n2) = 2, PSHAPE
    pair = _packed_pair(_div_free_state(PSHAPE, 47))
    leaf = 3 * n0 * (n1 // P) * (n2 // 2) * 4
    plane = 3 * n0 * (n1 // P) * 4
    want = 4 * (3 * 2 * leaf * (P - 1) // P + 2 * plane * (P - 1))
    for ex, names in pool.run("exchange_counter", PSHAPE, pair,
                              communication, True):
        assert ex == (want, 4 * (3 * spans + 1))
        assert "mpifft.solver.step" in names
    for ex, names in pool.run("exchange_counter", PSHAPE, pair,
                              communication, False):
        assert ex is None and names == []
