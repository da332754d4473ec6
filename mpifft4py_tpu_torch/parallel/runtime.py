"""Multi-process runtime: join the ``torch.distributed`` group.

Port of ``mpifft4py_tpu/parallel/runtime.py`` (``initialize``,
``is_initialized``).  The job launcher owns process bootstrap, as ``mpirun``
did for mpiFFT4py: under ``torchrun`` every process finds its rank, the
world size and the rendezvous in the environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``).
``hybrid_mesh`` waits for the pencil port (ROADMAP.md queue 1 item 5).

Usage (one process per rank)::

    from mpifft4py_tpu_torch.parallel import runtime
    runtime.initialize()              # no-op outside torchrun
    FFT = slab.R2C(N, L, None, "single")   # comm=None -> the whole group
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_initialized"]


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
