"""Shared machinery of the transform classes.

Port of ``mpifft4py_tpu/base.py``.  A transform object owns its grid, its
precision policy, an explicit ``device`` and its process group (``comm``:
``parallel.mesh.slab_group``); its transforms are plain functions on this
rank's tensors, cached per key in ``self._plans`` (the FFTW plan's role;
PyTorch runs eagerly, so nothing is compiled).  Where the reference's
single controller sees global arrays sharded over a mesh, a rank here holds
its own block: ``shard_real``/``shard_complex`` cut a global array to it,
``gather`` puts the blocks together again on every rank, and ``_stage``
is the transpose between the local FFT stages.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mpibase import DTypePolicy, resolve_precision, work_arrays
from .parallel import collectives
from .parallel.mesh import slab_group
from .utils.transfer import device_put, to_numpy

COMMUNICATIONS = ("Alltoall", "Alltoallw", "alltoall", "pipelined", "rdma")

DEALIAS = (None, "2/3-rule", "3/2-rule")


def _as_working(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as the reference's
    ``np.asarray(...).astype(FFT.float)`` constants are."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


class BaseFFT:
    """Constructor and bookkeeping shared by the transforms.

    The signature mirrors the reference, ``R2C(N, L, comm, precision, ...)``,
    plus ``device=`` (default ``"cuda"``; a missing card raises, it never
    turns into the CPU).  ``comm`` is ``None`` (the initialised default
    group, else this process alone), a ``ProcessGroup``, or an int equal
    to the group's size.  ``communication`` is the transpose at P > 1:
    "Alltoall"/"Alltoallw"/"alltoall" (the group's ``all_to_all_single``;
    NCCL on the card), "pipelined" (chunked, ``pipeline_chunks`` chunks
    posted asynchronously) or "rdma" (the peer-memory kernels of
    ``parallel.rdma``: on the card, P ranks may share one card over a gloo
    group).  ``threads`` and ``planner_effort`` are accepted for
    compatibility and ignored.
    """

    ndim: int = 3

    def __init__(self, N, L, comm=None, precision: str = "single", *,
                 communication: str = "Alltoall", padsize: float = 1.5,
                 threads=None, planner_effort=None, device="cuda",
                 pipeline_chunks: int = 4):
        del threads, planner_effort
        if communication not in COMMUNICATIONS:
            raise ValueError(f"unknown communication={communication!r}")
        self.group, self.P, self.rank = slab_group(comm)
        self.num_processes = self.P
        self._nchunks = int(pipeline_chunks)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device='cuda' but no CUDA device is "
                                   "available; pass device='cpu' for the CPU")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.N = np.array(N, dtype=np.int64)
        self.L = np.array(L, dtype=np.float64)
        if len(self.N) != self.ndim or len(self.L) != self.ndim:
            raise ValueError(f"N and L need {self.ndim} entries")
        self.communication = communication
        self.padsize = float(padsize)
        self.policy: DTypePolicy = resolve_precision(precision)
        self.float = self.policy.float
        self.complex = self.policy.complex
        self.work_arrays = work_arrays(self.device)
        self._plans: Dict[Tuple, Callable] = {}
        self._peers = None
        if communication == "rdma" and self.P > 1:
            from .parallel.rdma import PeerGroup
            self._peers = PeerGroup(self.group, self.P, self.rank,
                                    self.device)
        self._validate()

    def _validate(self) -> None:
        raise NotImplementedError

    # -- field placement ------------------------------------------------------
    #
    # Physical space is cut along its first axis (−ndim), spectral space
    # along its second (−ndim + 1); leading axes (component stacks) ride.

    def _block(self, a, axis: int):
        """This rank's block of ``a`` (numpy or tensor) along ``axis``."""
        if self.P == 1:
            return a
        n = a.shape[axis] // self.P
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(self.rank * n, (self.rank + 1) * n)
        return a[tuple(idx)]

    def shard_real(self, u) -> torch.Tensor:
        """This rank's block of a global physical-space array (any leading
        axes), as a tensor on ``self.device``."""
        return device_put(self._block(u, -self.ndim), self.float, self.device)

    def shard_complex(self, fu) -> torch.Tensor:
        """This rank's block of a global spectral array."""
        return device_put(self._block(fu, 1 - self.ndim), self.complex,
                          self.device)

    def gather(self, x) -> np.ndarray:
        """The global array of a local field (physical or spectral, told
        apart by the length of its first transformed axis), as host numpy
        on every rank.  Host-facing: it gathers on the host over gloo (on
        the card with NCCL)."""
        if self.P == 1:
            return to_numpy(x)
        spectral = x.shape[-self.ndim] == int(self.N[0])
        axis = x.ndim - self.ndim + (1 if spectral else 0)
        v = x.detach()
        if dist.get_backend(self.group) != "nccl":
            v = v.cpu()
        if v.is_complex():
            g = collectives.all_gather(torch.view_as_real(v.contiguous()),
                                       self.group, axis)
            return to_numpy(torch.view_as_complex(g.contiguous()))
        return to_numpy(collectives.all_gather(v, self.group, axis))

    def zeros_real(self) -> torch.Tensor:
        return torch.zeros(self.real_shape(), dtype=self.float,
                           device=self.device)

    def zeros_complex(self) -> torch.Tensor:
        return torch.zeros(self.complex_shape(), dtype=self.complex,
                           device=self.device)

    # -- physical coordinates -----------------------------------------------------

    def _local_coords(self):
        """The 1-D physical coordinates of this rank's block (the first
        axis starts at ``real_local_slice(rank)``)."""
        d = (self.L / self.N).astype(np.float64)
        start = (self.real_local_slice(self.rank)[0].start,) \
            + (0,) * (self.ndim - 1)
        return tuple((s + torch.arange(int(n), dtype=self.float,
                                       device=self.device))
                     * _as_working(di, self.float)
                     for s, n, di in zip(start, self.real_shape(), d))

    # -- the transpose stage ---------------------------------------------------------

    def _stage(self, x, split_axis: int, concat_axis: int, work_fn=None, *,
               pipeline_axis: int, pre_fn=None):
        """One transpose stage, ``work_fn(transpose(pre_fn(x)))``, over the
        group, for a tensor or a tuple of them: ``communication`` "pipelined"
        chunks along ``pipeline_axis`` (a free axis), "rdma" runs row 23
        (``parallel.rdma.rdma_all_to_all``; float32 leaves only: a complex
        leaf raises ``ValueError``, as in the reference), the others one
        ``all_to_all_single`` a leaf.  A world of one skips the exchange."""
        if self.P > 1 and self.communication == "pipelined":
            return collectives.transpose_pipelined(
                x, self.group, split_axis, concat_axis, work_fn,
                pipeline_axis, nchunks=self._nchunks, pre_fn=pre_fn)
        if pre_fn is not None:
            x = pre_fn(x)
        if self.P > 1:
            if self._peers is not None:
                from .parallel.rdma import rdma_all_to_all
                x = rdma_all_to_all(x, self._peers, split_axis, concat_axis)
            else:
                x = collectives.transpose(x, self.group, split_axis,
                                          concat_axis)
        return work_fn(x) if work_fn is not None else x

    def _all_gather(self, x, axis: int):
        """The tiled all-gather along ``axis`` over the group: row 23 under
        "rdma" on the card, the group's ``all_gather`` otherwise."""
        if self._peers is not None:
            from .parallel.rdma import rdma_all_gather
            return rdma_all_gather(x, self._peers, axis)
        return collectives.all_gather(x, self.group, axis)

    def _all_reduce(self, t):
        """The sum of a (scalar) tensor over the group."""
        return collectives.all_reduce(t, self.group)

    def get_local_mesh(self) -> torch.Tensor:
        """(ndim,) + real_shape() physical coordinates."""
        return torch.stack(torch.meshgrid(*self._local_coords(),
                                          indexing="ij"))

    def _check_dealias(self, dealias):
        if dealias not in DEALIAS:
            raise ValueError(f"unknown dealias={dealias!r}")

    # -- plan cache --------------------------------------------------------------

    def _plan(self, key: Tuple, builder: Callable[[], Callable]) -> Callable:
        fn = self._plans.get(key)
        if fn is None:
            fn = self._plans[key] = builder()
        return fn

    def _coerce(self, a, dtype) -> torch.Tensor:
        if (isinstance(a, torch.Tensor) and a.dtype == dtype
                and a.device == self.device):
            return a
        return device_put(a, dtype, self.device)

    # -- batched multi-component transforms -------------------------------------

    def forward_fields_fn(self, dealias=None) -> Callable:
        """Forward transform of a stack of fields, (C,) + work shape ->
        (C,) + complex shape.  The transforms act on the last three axes, so
        the whole stack rides one call (one launch sequence, not C)."""
        return self.forward_fn(dealias)

    def backward_fields_fn(self, dealias=None) -> Callable:
        return self.backward_fn(dealias)
