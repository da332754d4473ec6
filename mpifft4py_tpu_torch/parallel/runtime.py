"""Multi-process runtime: join the ``torch.distributed`` group.

Port of ``mpifft4py_tpu/parallel/runtime.py`` (``initialize``,
``is_initialized``, ``hybrid_mesh``).  The job launcher owns process
bootstrap, as ``mpirun`` did for mpiFFT4py: under ``torchrun`` every
process finds its rank, the world size and the rendezvous in the
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``,
``LOCAL_RANK``).  ``hybrid_mesh`` lays the ranks out host by host, so the
pencil's sub-groups can stay inside one host.

Usage (one process per rank)::

    from mpifft4py_tpu_torch.parallel import runtime
    runtime.initialize()              # no-op outside torchrun
    FFT = slab.R2C(N, L, None, "single")   # comm=None -> the whole group
    FFT = pencil.R2C(N, L, None, "single", P1=2)   # a 2 x P/2 grid
"""

from __future__ import annotations

import os
import socket
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "is_initialized", "hybrid_mesh"]


def is_initialized() -> bool:
    """True once this process has joined a ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized()


def initialize(backend: str | None = None, **kw) -> None:
    """Join the group described by the ``torchrun`` environment, once.

    A no-op when the group is already initialised, or when the
    environment names no world (a plain single-process run).  The rank's
    card is ``LOCAL_RANK % device_count()``, so P ranks may share one card
    (then ``backend="gloo"`` and ``communication="rdma"``: NCCL refuses
    two ranks on one card).  ``backend`` defaults to NCCL with a card,
    gloo without; ``kw`` goes to ``init_process_group``."""
    if is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    cuda = torch.cuda.is_available()
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend or ("nccl" if cuda else "gloo"), **kw)


def hybrid_mesh(ici_shape: Sequence[int], axis_names: Sequence[str],
                dcn_axis: str = "dcn", hosts=None) -> np.ndarray:
    """The ranks as an integer array of shape (G,) + ``ici_shape``, a
    granule (a host) along the outer axis.

    Port of the reference's ``runtime.hybrid_mesh``: the inner axes
    (``axis_names``, one a dimension of ``ici_shape``) never cross a host,
    so a pencil's sub-groups built on a (P1, P2) slice ride the host's
    NVLink, and only the outer ``dcn_axis`` crosses hosts (for batch or
    ensemble parallelism).  Granules are the hosts' names, read with
    ``dist.all_gather_object`` of ``socket.gethostname()`` (one rank, one
    host when ``torch.distributed`` is not initialised); ``hosts``, one
    name a rank in rank order, replaces them (tests compose meshes
    offline).  Granules are ordered by name and hold their ranks in
    increasing order; each host's ranks pass the slice ``mesh[g]`` that
    holds them to ``pencil_groups``, and each host builds its own.  Every
    granule must hold exactly prod(ici_shape) ranks (ValueError).
    ``axis_names`` and ``dcn_axis`` name the axes, as the reference's
    ``Mesh`` does; the array carries no names."""
    ici_shape = tuple(int(n) for n in ici_shape)
    if len(tuple(axis_names)) != len(ici_shape) or dcn_axis in axis_names:
        raise ValueError(f"axis_names {tuple(axis_names)} must name each of "
                         f"the {len(ici_shape)} inner axes once, apart from "
                         f"dcn_axis={dcn_axis!r}")
    if hosts is None:
        if is_initialized():
            hosts = [None] * dist.get_world_size()
            dist.all_gather_object(hosts, socket.gethostname())
        else:
            hosts = [socket.gethostname()]
    granules: dict = {}
    for rank, host in enumerate(hosts):
        granules.setdefault(host, []).append(rank)
    groups = [granules[k] for k in sorted(granules)]
    per = int(np.prod(ici_shape))
    if any(len(g) != per for g in groups):
        raise ValueError(
            f"each ICI granule must have exactly prod(ici_shape)={per} "
            f"ranks; got granule sizes {[len(g) for g in groups]}")
    return np.array([np.asarray(g).reshape(ici_shape) for g in groups],
                    dtype=np.int64)
