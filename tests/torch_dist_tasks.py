"""A pool of gloo ranks for the port's distributed tests, and the tasks
they run.

The pool's ranks are processes started with the spawn method; each joins a
gloo group through a ``FileStore``, runs with one intra-op torch thread, and
then runs tasks: a function of this module called as ``fn(*args)`` on every
rank at once, whose results (numpy arrays, scalars) come back in rank order.
This module imports torch and the port, never JAX, so a rank starts in a
second or two.  pytest does not collect it (its name is not ``test_*``).
"""

from __future__ import annotations

import os
import queue
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TAU = 2 * np.pi
TIMEOUT = 120       # seconds a task may take on a rank


def _main(rank, P, store, inq, outq):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, P),
                            rank=rank, world_size=P)
    while True:
        task = inq.get()
        if task is None:
            break
        fn, args = task
        try:
            outq.put((rank, True, globals()[fn](*args)))
        except BaseException:   # reported to the test, which raises it
            outq.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """P gloo ranks (spawned processes) that run tasks together."""

    def __init__(self, P: int, store: str):
        ctx = mp.get_context("spawn")
        self.P = P
        self.inq = [ctx.Queue() for _ in range(P)]
        self.outq = ctx.Queue()
        self.procs = [ctx.Process(target=_main, daemon=True,
                                  args=(r, P, store, self.inq[r], self.outq))
                      for r in range(P)]
        for p in self.procs:
            p.start()

    def run(self, fn: str, *args):
        """``fn(*args)`` on every rank; the results in rank order.  Raises
        with a rank's traceback if it failed."""
        for q in self.inq:
            q.put((fn, args))
        got = {}
        for _ in range(self.P):
            try:
                rank, ok, res = self.outq.get(timeout=TIMEOUT)
            except queue.Empty:
                raise RuntimeError(f"{fn}: a rank gave no result in "
                                   f"{TIMEOUT} s") from None
            got[rank] = (ok, res)
        failed = [f"rank {r}:\n{res}" for r, (ok, res) in sorted(got.items())
                  if not ok]
        if failed:
            raise RuntimeError(f"{fn} failed\n" + "\n".join(failed))
        return [got[r][1] for r in range(self.P)]

    def close(self):
        for q in self.inq:
            q.put(None)
        for p in self.procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
                p.join(5)


# -- tasks (run on every rank; ``dist`` is initialised) ------------------------

def _rank():
    return dist.get_rank(), dist.get_world_size()


def transpose_blocks(shape, split, concat, pipelined):
    """Each rank's (P-distinct) block through ``transpose`` or
    ``transpose_pipelined`` (work: ×2)."""
    from mpifft4py_tpu_torch.parallel import collectives
    rank, P = _rank()
    x = torch.from_numpy(np.arange(np.prod(shape), dtype=np.float32)
                         .reshape(shape) + 1e4 * rank)
    if not pipelined:
        return collectives.transpose(x, dist.group.WORLD, split,
                                     concat).numpy()
    free = ({0, 1, 2} - {split, concat}).pop()
    return collectives.transpose_pipelined(
        (x, -x), dist.group.WORLD, split, concat, lambda t: (2 * t[0], t[1]),
        free, nchunks=3)[0].numpy()


def rdma_group_plain(shape, seed):
    """The group-level rows 23/24/25 on CPU tensors (their plain twins
    over the group): the all-to-all (1 → 0) of a pair, the fused forward
    of the pair and the fused inverse of that."""
    from mpifft4py_tpu_torch.parallel import rdma
    rank, P = _rank()
    peers = rdma.PeerGroup(dist.group.WORLD, P, rank, "cpu")
    g = np.random.default_rng(seed)
    yr, yi = (g.standard_normal(shape).astype(np.float32) for _ in range(2))
    n0 = shape[0] // P
    blk = slice(rank * n0, (rank + 1) * n0)
    yr, yi = torch.from_numpy(yr[blk]), torch.from_numpy(yi[blk])
    a2a = rdma.rdma_all_to_all((yr, yi), peers, 1, 0)
    fr, fi = rdma.fused_transpose_fft_x(yr, yi, peers)
    br, bi = rdma.fused_ifft_x_transpose(fr.contiguous(), fi.contiguous(),
                                         peers)
    return [a.numpy() for a in (*a2a, fr, fi, br, bi)]


def _fft(kind, shape, precision, communication, device="cpu", **kw):
    from mpifft4py_tpu_torch import slab
    cls = slab.R2C if kind == "R2C" else slab.C2C
    return cls(np.array(shape), np.array([TAU] * 3), None, precision,
               communication=communication, device=device, **kw)


def slab_transform(kind, shape, precision, communication, dealias, u):
    """Gathered forward and round trip of the global field ``u`` at
    P > 1, and this rank's local slices and shapes."""
    rank, P = _rank()
    FFT = _fft(kind, shape, precision, communication)
    fu = FFT.fftn(FFT.shard_real(u), dealias=dealias)
    ub = FFT.ifftn(fu, dealias=dealias)
    return (FFT.gather(fu), FFT.gather(ub), FFT.real_local_slice(rank),
            FFT.complex_local_slice(rank), FFT.real_shape(),
            FFT.complex_shape(), tuple(fu.shape), tuple(ub.shape))


def slab_expect_raise(kind, shape, precision, communication, dealias, u):
    """The exception type name and message a transform raises."""
    try:
        slab_transform(kind, shape, precision, communication, dealias, u)
    except Exception as err:        # the test asserts what was raised
        return type(err).__name__, str(err)
    return None, None


def packed_interface(shape, communication, dealias, U):
    """forward_packed_fn / backward_packed_fn of a 3-stack at P > 1:
    the gathered pair and the gathered round trip."""
    FFT = _fft("R2C", shape, "single", communication)
    yr, yi = FFT.forward_packed_fn(dealias)(FFT.shard_real(U))
    back = FFT.backward_packed_fn(dealias)((yr, yi))
    return FFT.gather(yr), FFT.gather(yi), FFT.gather(back)


def nl_epilogue(shape, communication, phys, Sr, Si, mode, op, visc):
    """nl_forward_epilogue_fn at P > 1 on the ranks' blocks of global
    fields, with the global 1-D wavenumbers and masks."""
    from mpifft4py_tpu_torch.utils import spectral
    FFT = _fft("R2C", shape, "single", communication)
    N = FFT.N
    kv = spectral.factored_wavenumbers(N, FFT.L, int(N[2]) // 2)
    mv = spectral.packed_dealias_masks(N)
    fn = FFT.nl_forward_epilogue_fn(mode, visc, op=op)
    sr, si = (torch.from_numpy(np.ascontiguousarray(FFT._cut(a, "packed")))
              for a in (Sr, Si))
    d = fn(*(FFT.shard_real(a) for a in phys), sr, si, *kv, *mv)
    return FFT.gather(d[0]), FFT.gather(d[1])


def ns3d_steps(shape, layout, communication, state, n_steps, nu, dt):
    """``n_steps`` RK4 steps of NavierStokes3D from the global ``state``
    (complex (3, N0, N1, Nf), or a packed (2, 3, N0, N1, h) float32
    array): the gathered final state and the solver's energy of it."""
    from mpifft4py_tpu_torch.models import NavierStokes3D
    from mpifft4py_tpu_torch.utils.transfer import (
        packed_state_from_reference, state_from_reference)
    FFT = _fft("R2C", shape, "single", communication)
    s = NavierStokes3D(FFT, nu, dt, spectral_layout=layout)
    S = (packed_state_from_reference((state[0], state[1]), FFT)
         if layout == "packed" else state_from_reference(state, FFT))
    S = s.run(S, n_steps)
    e = s.energy(S)
    return FFT.gather(S), e


def ns3d_forced(shape, layout, integrator, state, n_steps, kw):
    """``n_steps`` steps with band forcing and ``integrator`` from the
    global ``state`` (complex, or a packed pair array): the gathered state,
    the energy, the energy spectrum and the dissipation."""
    from mpifft4py_tpu_torch.models import NavierStokes3D
    from mpifft4py_tpu_torch.models.diagnostics import (
        dissipation, dissipation_packed, energy_spectrum,
        energy_spectrum_packed)
    from mpifft4py_tpu_torch.utils.transfer import (
        packed_state_from_reference, state_from_reference)
    FFT = _fft("R2C", shape, "single", "alltoall")
    s = NavierStokes3D(FFT, spectral_layout=layout, integrator=integrator,
                       **kw)
    S = (packed_state_from_reference((state[0], state[1]), FFT)
         if layout == "packed" else state_from_reference(state, FFT))
    if integrator == "AB2":
        S = s.ab2_state(S)
    S = s._carry_state(s.run(S, n_steps))
    if layout == "packed":
        diag = (energy_spectrum_packed(FFT, S),
                dissipation_packed(FFT, S, kw["nu"]))
    else:
        diag = energy_spectrum(FFT, S), dissipation(FFT, S, kw["nu"])
    return FFT.gather(S), s.energy(S), *diag


def family_and_line_raise(shape):
    """What the family and line.R2C raise at P > 1."""
    from mpifft4py_tpu_torch import line
    from mpifft4py_tpu_torch.models import (MHD3D, Boussinesq3D,
                                            VorticityVelocity3D)
    FFT = _fft("R2C", shape, "single", "alltoall")
    out = []
    for make in (lambda: VorticityVelocity3D(FFT, 0.01, 0.01),
                 lambda: MHD3D(FFT, 0.01, 0.01, 0.01),
                 lambda: Boussinesq3D(FFT, 0.01, 0.01, 0.01),
                 lambda: line.R2C(np.array(shape[:2]), np.array([TAU] * 2),
                                  None, "single", device="cpu")):
        try:
            make()
            out.append(None)
        except NotImplementedError as err:
            out.append(str(err))
    return out


# -- the benchmark's slab reference and entry (benchmarks_torch/) -------------

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks_torch")


def _bench():
    """The benchmark's modules (``reference``, ``entries``) importable."""
    import sys
    if BENCH not in sys.path:
        sys.path.append(BENCH)


def ns3d_packed_vs_slab_reference(shape, pair, n_steps, nu, dt):
    """The port's packed NS3D at P > 1 (alltoall) and the benchmark's
    float64 slab reference over the same group, ``n_steps`` RK4 steps from
    the global packed ``pair``: (largest gap, largest reference
    coefficient) of this rank's block, and the largest gap of the slab
    ``packed_to_complex`` against the one-process conversion."""
    _bench()
    from mpifft4py_tpu_torch.models import NavierStokes3D
    from mpifft4py_tpu_torch.utils.transfer import packed_state_from_reference
    from reference.layouts import packed_to_complex
    from reference.ns3d_slab import NS3DSlab, to_complex
    rank, P = _rank()
    group = dist.group.WORLD
    FFT = _fft("R2C", shape, "single", "alltoall")
    s = NavierStokes3D(FFT, nu, dt, spectral_layout="packed")
    S = packed_state_from_reference(pair, FFT)
    U = to_complex(S, group)
    blk = FFT.local_spectral_slices("complex")[1]
    whole = packed_to_complex(torch.from_numpy(np.stack(pair)))
    conv = float((U - whole[:, :, blk]).abs().max())
    out = s.run(S, n_steps)
    ref = NS3DSlab(shape, [TAU] * 3, nu, dt, "2/3-rule", "float64", "cpu",
                   group)
    for _ in range(n_steps):
        U = ref.step(U)
    gap = float((to_complex(out, group) - U).abs().max())
    return gap, float(U.abs().max()), conv


def ns3d_slab_vs_one_process(shape, U, n_steps, nu, dt):
    """The benchmark's float64 slab reference at P > 1 against its
    one-process ``NS3D`` on the global complex128 state ``U``: the largest
    gaps of this rank's block after ``n_steps`` RK4 steps and of its
    Taylor–Green block, the largest coefficient, and both energies."""
    _bench()
    from reference.ns3d import NS3D
    from reference.ns3d_slab import NS3DSlab
    rank, P = _rank()
    n1 = shape[1] // P
    blk = slice(rank * n1, (rank + 1) * n1)
    args = (shape, [TAU] * 3, nu, dt, "2/3-rule", "float64", "cpu")
    slab, one = NS3DSlab(*args, dist.group.WORLD), NS3D(*args)
    tg = float((slab.taylor_green("cpu")
                - one.taylor_green("cpu")[:, :, blk]).abs().max())
    U = torch.from_numpy(U)
    Ub = U[:, :, blk].contiguous()
    for _ in range(n_steps):
        Ub, U = slab.step(Ub), one.step(U)
    return (float((Ub - U[:, :, blk]).abs().max()), tg,
            float(U.abs().max()), slab.energy(Ub), one.energy(U))


def slab_entry_state(cfg, traffic, seed):
    """The global initial state of the benchmark's ``ns3d_slab`` entry
    built on the group's ranks."""
    _bench()
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "entry_ns3d_slab", os.path.join(BENCH, "entries", "ns3d_slab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    e = mod.Entry(cfg, traffic, seed, "cpu", comm=dist.group.WORLD)
    return e.solver.FFT.gather(e.state)


def exchange_counter(shape, pair, communication, tracing):
    """One packed NS3D RK4 step at P > 1 with tracing on or off: the
    exchange span's (bytes, count), None where it did not record, and the
    names of the spans that did."""
    from mpifft4py_tpu_torch.models import NavierStokes3D
    from mpifft4py_tpu_torch.utils import profiling
    from mpifft4py_tpu_torch.utils.transfer import packed_state_from_reference
    FFT = _fft("R2C", shape, "single", communication)
    s = NavierStokes3D(FFT, 0.01, 0.001, spectral_layout="packed")
    S = packed_state_from_reference(pair, FFT)
    profiling.reset()
    if tracing:
        profiling.enable()
    try:
        s.step(S)
    finally:
        profiling.disable()
    r = profiling.report()
    profiling.reset()
    ex = r.get("mpifft.transform.exchange")
    return (None if ex is None else (ex["bytes"], ex["count"])), sorted(r)


def store_path(tmpdir, name):
    return os.path.join(str(tmpdir), name)


# -- the pencil (P1×P2 grids of the pool's ranks) -------------------------------

def _pencil(kind, shape, precision, communication, P1, alignment="X",
            device="cpu"):
    from mpifft4py_tpu_torch import pencil
    cls = pencil.R2C if kind == "R2C" else pencil.C2C
    return cls(np.array(shape), np.array([TAU] * 3), None, precision, P1=P1,
               alignment=alignment, communication=communication,
               device=device)


def pencil_transform(kind, shape, precision, communication, P1, alignment,
                     dealias, u):
    """Gathered forward and round trip of the global field ``u`` on a
    P1×P2 pencil, and this rank's coordinates, local slices and shapes."""
    F = _pencil(kind, shape, precision, communication, P1, alignment)
    fu = F.fftn(F.shard_real(u), dealias=dealias)
    ub = F.ifftn(fu, dealias=dealias)
    rc = (F.r1, F.r2)
    return (F.gather(fu), F.gather(ub), F.real_local_slice(rc),
            F.complex_local_slice(rc), F.real_shape(), F.complex_shape(),
            tuple(fu.shape), tuple(ub.shape))


def pencil_meshes(shape, P1, alignment):
    """The gathered wavenumber mesh, scaled mesh, dealias filter and
    physical mesh of an R2C pencil."""
    F = _pencil("R2C", shape, "single", "alltoall", P1, alignment)
    K = F.get_local_wavenumbermesh()
    return (F.gather(K), F.gather(F.get_scaled_local_wavenumbermesh()),
            F.gather(F.get_dealias_filter().to(torch.int8)),
            F.gather(F.get_local_mesh()))


def pencil_expect_raise(kind, shape, precision, communication, P1,
                        alignment, dealias, u):
    """The exception type name and message a pencil transform raises."""
    try:
        pencil_transform(kind, shape, precision, communication, P1,
                         alignment, dealias, u)
    except Exception as err:        # the test asserts what was raised
        return type(err).__name__, str(err)
    return None, None


def pencil_packed(shape, communication, P1, dealias, U):
    """The pencil's packed interface of a 3-stack: the gathered pair and
    the gathered round trip."""
    F = _pencil("R2C", shape, "single", communication, P1)
    yr, yi = F.forward_packed_fn(dealias)(F.shard_real(U))
    back = F.backward_packed_fn(dealias)((yr, yi))
    return F.gather(yr), F.gather(yi), F.gather(back)


def pencil_nl_epilogue(shape, communication, P1, phys, Sr, Si, mode, op,
                       visc):
    """The pencil's nl_forward_epilogue_fn on the ranks' blocks of global
    fields, with the global 1-D wavenumbers and masks."""
    from mpifft4py_tpu_torch.utils import spectral
    F = _pencil("R2C", shape, "single", communication, P1)
    N = F.N
    kv = spectral.factored_wavenumbers(N, F.L, int(N[2]) // 2)
    mv = spectral.packed_dealias_masks(N)
    fn = F.nl_forward_epilogue_fn(mode, visc, op=op)
    sr, si = (torch.from_numpy(np.ascontiguousarray(F._cut(a, "packed")))
              for a in (Sr, Si))
    d = fn(*(F.shard_real(a) for a in phys), sr, si, *kv, *mv)
    return F.gather(d[0]), F.gather(d[1])


def pencil_ns3d_steps(shape, layout, communication, P1, state, n_steps, nu,
                      dt):
    """``n_steps`` RK4 steps of NavierStokes3D on a pencil from the global
    ``state`` (complex (3, N0, N1, Nfp), or a packed (2, 3, N0, N1, h)
    float32 array): the gathered final state, the solver's energy, its
    Parseval monitor, the energy spectrum and the dissipation."""
    from mpifft4py_tpu_torch.models import NavierStokes3D
    from mpifft4py_tpu_torch.models.diagnostics import (
        dissipation, dissipation_packed, energy_spectrum,
        energy_spectrum_packed)
    from mpifft4py_tpu_torch.utils.transfer import (
        packed_state_from_reference, state_from_reference)
    F = _pencil("R2C", shape, "single", communication, P1)
    s = NavierStokes3D(F, nu, dt, spectral_layout=layout)
    S = (packed_state_from_reference((state[0], state[1]), F)
         if layout == "packed" else state_from_reference(state, F))
    S, trace = s.run(S, n_steps, monitor_every=n_steps)
    diag = ((energy_spectrum_packed(F, S), dissipation_packed(F, S, nu))
            if layout == "packed" else
            (energy_spectrum(F, S), dissipation(F, S, nu)))
    return F.gather(S), s.energy(S), float(trace[-1]), *diag


def _grid_case(case):
    """The pencil comm of a grid case: P1 over the default group,
    "hybrid" (the one-host slice of ``runtime.hybrid_mesh((2, 2), …)``),
    "permuted" (the 4 ranks reversed as a 2×2 array), or "hosts2x1"/
    "hosts1x2" (two given hosts, "b a b a" and "a a b b": the slice of
    ``hybrid_mesh((2, 1)`` or ``(1, 2), …, hosts=…)`` that holds this rank,
    so each host builds its own grid at the same time)."""
    from mpifft4py_tpu_torch.parallel import runtime
    if case == "hybrid":
        return runtime.hybrid_mesh((2, 2), ("p1", "p2"))[0], None
    if case == "permuted":
        return np.arange(4)[::-1].reshape(2, 2), None
    if case in ("hosts2x1", "hosts1x2"):
        ici, hosts = (((2, 1), "baba") if case == "hosts2x1"
                      else ((1, 2), "aabb"))
        mesh = runtime.hybrid_mesh(ici, ("p1", "p2"), hosts=list(hosts))
        return next(m for m in mesh if dist.get_rank() in m), None
    return None, case


def pencil_groups_layout(case):
    """This rank's (P1, P2, r1, r2) and the global ranks, in group order,
    of its column group, its row group and the grid's group."""
    from mpifft4py_tpu_torch.parallel.mesh import pencil_comm
    group, g1, g2, p1, p2, r1, r2 = pencil_comm(*_grid_case(case))
    ranks = [None if g is None else
             [dist.get_global_rank(g, i) for i in range(dist.get_world_size(g))]
             for g in (g1, g2, group)]
    return p1, p2, r1, r2, ranks


def pencil_on_grid(case, shape, communication, u):
    """The gathered forward and round trip of ``u`` on an R2C pencil whose
    comm is a ``_grid_case``, and the grid's ranks."""
    from mpifft4py_tpu_torch import pencil
    comm, P1 = _grid_case(case)
    F = pencil.R2C(np.array(shape), np.array([TAU] * 3), comm, "single",
                   P1=P1, communication=communication, device="cpu")
    fu = F.fftn(F.shard_real(u))
    return F.gather(fu), F.gather(F.ifftn(fu)), (F.P1, F.P2)
