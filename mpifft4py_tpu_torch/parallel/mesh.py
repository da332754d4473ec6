"""The decompositions' process groups — the port's "communicator".

Port of ``mpifft4py_tpu/parallel/mesh.py``.  The reference builds a
``jax.sharding.Mesh`` over devices of one controller; here a rank is a
process of a ``torch.distributed`` group.

``slab_group(comm)`` resolves the slab's (and the line's) ``comm``:

* ``None``: the default process group when ``torch.distributed`` is
  initialised, else a world of one (this process alone);
* a ``ProcessGroup``: used as it is;
* an int ``P``: must equal the size of the default group (a world of one
  when it is not initialised); the reference's "first P devices" has no
  counterpart, because a process cannot hand its rank to another.

``pencil_groups(comm, P1)`` is the counterpart of the reference's
``pencil_mesh``: the two orthogonal sub-groups of a P1×P2 grid of ranks
(the reference's ``Comm.Split`` in mpiFFT4py, the named axes "p1" and
"p2" of a 2-D ``Mesh`` in the JAX package); ``pencil_comm`` adds the
group over the whole grid.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

__all__ = ["slab_group", "pencil_groups", "pencil_comm", "check_divisible"]


def _world():
    """``(group, P, rank)`` of the default group, or a world of one."""
    on = dist.is_available() and dist.is_initialized()
    P = dist.get_world_size() if on else 1
    return (dist.group.WORLD if on and P > 1 else None), P, \
        (dist.get_rank() if on else 0)


def slab_group(comm=None):
    """``(group, P, rank)`` of ``comm``; ``group`` is None for a world of
    one."""
    if comm is None or isinstance(comm, int):
        group, P, rank = _world()
        if isinstance(comm, int) and comm != P:
            raise ValueError(
                f"comm={comm}: the slab group has {P} rank(s); a rank is a "
                f"process, so P is the size of the initialised "
                f"torch.distributed group (torchrun --nproc-per-node={comm})")
        return group, P, rank
    if isinstance(comm, dist.ProcessGroup):
        P = dist.get_world_size(comm)
        return (comm if P > 1 else None), P, dist.get_rank(comm)
    raise TypeError(f"comm must be None, an int or a ProcessGroup, got "
                    f"{type(comm).__name__}")


# the groups of each rank list, made once a process: a group holds its own
# connections to its members, torch names it by its ranks, and a job
# builds many transforms on one grid
_GROUPS: dict = {}


def _group(ranks):
    """The process group of the global ``ranks``, in group-rank order.

    Only its members create it (``use_local_synchronization``), so the
    ranks of one host can build their grid while another host builds its
    own.  An unsorted list keeps its order (``sort_ranks=False``)."""
    ranks = [int(r) for r in ranks]
    key = (id(dist.group.WORLD), tuple(ranks))
    if key not in _GROUPS:
        kw = {} if ranks == sorted(ranks) else {"sort_ranks": False}
        _GROUPS[key] = dist.new_group(ranks, use_local_synchronization=True,
                                      **kw)
    return _GROUPS[key]


def _grid_of(comm, P1):
    """``(grid, group)``: the (P1, P2) integer array of global ranks that
    ``comm`` names, and the group over all of them (None: make it)."""
    group = None
    if isinstance(comm, dist.ProcessGroup):
        group = comm
        ranks = [dist.get_global_rank(comm, i)
                 for i in range(dist.get_world_size(comm))]
    elif comm is None or isinstance(comm, int):
        group, P, _ = slab_group(comm)
        ranks = list(range(P))
    else:
        grid = np.asarray(comm)
        if grid.ndim != 2 or not np.issubdtype(grid.dtype, np.integer):
            raise ValueError(f"a pencil comm array must be a (P1, P2) "
                             f"integer array of ranks, got shape "
                             f"{grid.shape} {grid.dtype}")
        if P1 is not None and int(P1) != grid.shape[0]:
            raise ValueError(f"P1={P1} contradicts the comm array's "
                             f"{grid.shape[0]} rows")
        if len(np.unique(grid)) != grid.size:
            raise ValueError(f"the comm array {grid.tolist()} repeats a rank")
        return grid.astype(np.int64), None
    P = len(ranks)
    if P1 is None:      # the most square factorisation, P1 <= P2
        P1 = int(np.sqrt(P))
        while P % P1:
            P1 -= 1
    P1 = int(P1)
    if P1 < 1 or P % P1:
        raise ValueError(f"P1={P1} does not divide the group's {P} ranks")
    return np.asarray(ranks, dtype=np.int64).reshape(P1, P // P1), group


def pencil_comm(comm=None, P1=None):
    """``(group, group1, group2, P1, P2, r1, r2)`` of a P1×P2 grid of
    ranks: ``pencil_groups`` and the group over the whole grid (its rank
    is r1·P2 + r2; None for a grid of one)."""
    grid, group = _grid_of(comm, P1)
    P1, P2 = (int(n) for n in grid.shape)
    _, world, me = _world()
    if grid.min() < 0 or grid.max() >= world:
        raise ValueError(f"the comm grid {grid.tolist()} names ranks "
                         f"outside the default group's {world}")
    at = np.argwhere(grid == me)
    if not len(at):
        raise ValueError(f"rank {me} is not in the pencil comm array "
                         f"{grid.tolist()}: each rank passes the slice that "
                         f"holds it (e.g. mesh[g] of its own host)")
    r1, r2 = (int(i) for i in at[0])
    if grid.size == 1:
        return None, None, None, 1, 1, 0, 0
    if group is None:
        natural = grid.size == world and (grid.ravel() == np.arange(world)
                                          ).all()
        group = dist.group.WORLD if natural else _group(grid.ravel())
    # a sub-group that spans the grid is the grid's group itself
    g1 = None if P1 == 1 else group if P2 == 1 else _group(grid[:, r2])
    g2 = None if P2 == 1 else group if P1 == 1 else _group(grid[r1, :])
    return group, g1, g2, P1, P2, r1, r2


def pencil_groups(comm=None, P1=None):
    """``(group1, group2, P1, P2, r1, r2)`` of a P1×P2 grid of ranks.

    ``group1`` is this rank's column of the grid (the P1 ranks that share
    its r2: the transposes over P1 ride it), ``group2`` its row (the P2
    ranks that share r1); each is None when it has one rank, and is the
    grid's whole group when it spans the grid.  ``comm`` is None or an int
    (the default group), a ``ProcessGroup``, or a (P1, P2) integer array
    of global ranks (the reference's 2-D ``Mesh`` argument, e.g. the slice
    ``mesh[g]`` of ``runtime.hybrid_mesh`` that holds this rank: each host
    builds its own).  (r1, r2) is this rank's place in the grid, and every
    group orders its ranks as the grid does: the grid's group ranks them
    r1·P2 + r2 (the pencil's joint transposes concatenate in that order),
    as the reference reshapes its devices to (P1, P2); None, an int and a
    group are laid out so, in their rank order.  ``P1`` defaults to the
    most square factor with P1 <= P2; one that does not divide P raises.

    Only a group's members create it (``dist.new_group`` with
    ``use_local_synchronization``): every rank of the grid creates the
    grid's group, then its column, then its row.  The groups are cached
    per rank list, so building many transforms on one grid makes them
    once."""
    return pencil_comm(comm, P1)[1:]


def check_divisible(N, P: int, what: str):
    """The reference keeps hard N % P == 0 checks; so does the port."""
    if int(N) % int(P) != 0:
        raise ValueError(f"{what}: size {N} not divisible by {P} ranks")
