"""The slab's process group — the port's "communicator".

Port of ``mpifft4py_tpu/parallel/mesh.py`` for the slab (1-D)
decomposition.  The reference builds a ``jax.sharding.Mesh`` over devices
of one controller; here a rank is a process of a ``torch.distributed``
group, so the ``comm`` argument of the transform constructors accepts:

* ``None``: the default process group when ``torch.distributed`` is
  initialised, else a world of one (this process alone);
* a ``ProcessGroup``: used as it is;
* an int ``P``: must equal the size of the default group (a world of one
  when it is not initialised); the reference's "first P devices" has no
  counterpart, because a process cannot hand its rank to another.

The pencil's two sub-groups wait for the pencil port (ROADMAP.md queue 1
item 5).
"""

from __future__ import annotations

import torch.distributed as dist

__all__ = ["slab_group", "check_divisible"]


def slab_group(comm=None):
    """``(group, P, rank)`` of ``comm``; ``group`` is None for a world of
    one."""
    if comm is None or isinstance(comm, int):
        on = dist.is_available() and dist.is_initialized()
        group = dist.group.WORLD if on else None
        P = dist.get_world_size() if on else 1
        if isinstance(comm, int) and comm != P:
            raise ValueError(
                f"comm={comm}: the slab group has {P} rank(s); a rank is a "
                f"process, so P is the size of the initialised "
                f"torch.distributed group (torchrun --nproc-per-node={comm})")
        rank = dist.get_rank() if on else 0
        return (group if P > 1 else None), P, rank
    if isinstance(comm, dist.ProcessGroup):
        P = dist.get_world_size(comm)
        return (comm if P > 1 else None), P, dist.get_rank(comm)
    raise TypeError(f"comm must be None, an int or a ProcessGroup, got "
                    f"{type(comm).__name__}")


def check_divisible(N, P: int, what: str):
    """The reference keeps hard N % P == 0 checks; so does the port."""
    if int(N) % int(P) != 0:
        raise ValueError(f"{what}: size {N} not divisible by {P} ranks")
