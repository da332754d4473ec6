"""Shared machinery of the transform classes.

Port of ``mpifft4py_tpu/base.py``.  A transform object owns its grid, its
precision policy, an explicit ``device`` and its process group (``comm``:
``parallel.mesh.slab_group``, or the pencil's grid); its transforms are
plain functions on this rank's tensors, cached per key in ``self._plans``
(the FFTW plan's role; PyTorch runs eagerly, so nothing is compiled).
Where the reference's single controller sees global arrays sharded over a
mesh, a rank here holds its own block, placed by the class's block map
(``_cuts``: the slab cuts one axis, the pencil two):
``shard_real``/``shard_complex`` cut a global array to it, ``gather`` puts
the blocks together again on every rank, and ``_stage`` is the transpose
between the local FFT stages, over the whole group or a sub-group.
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
        self.group, self.P, self.rank = self._resolve_comm(comm)
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

    def _resolve_comm(self, comm):
        """``(group, P, rank)`` of the transform's whole group: the slab's
        (``parallel.mesh.slab_group``); the pencil resolves its grid."""
        return slab_group(comm)

    def _validate(self) -> None:
        raise NotImplementedError

    # -- field placement ------------------------------------------------------
    #
    # A block map per class: ``_cuts(kind, rank)`` says which of the last
    # ndim axes of a global array of ``kind`` ("real": physical space on
    # the N or the padded M grid; "complex": the spectrum; "packed": the
    # packed planar pair) are cut, into how many parts, and which part
    # ``rank`` of the group holds.  The slab cuts physical space along its
    # first axis (−ndim) and spectral space along its second (−ndim + 1);
    # leading axes (component stacks) ride.

    def _cuts(self, kind: str, rank: int):
        """{axis: (parts, index)} of ``rank``'s block of a ``kind`` array."""
        return {0 if kind == "real" else 1: (self.P, rank)}

    def _block_slices(self, shape, kind: str, rank: int):
        """Slices of the last ndim axes of a global array of ``shape``
        that ``rank`` holds."""
        cuts = self._cuts(kind, rank)
        out = []
        for a, n in enumerate(shape[-self.ndim:]):
            parts, i = cuts.get(a, (1, 0))
            m = int(n) // parts
            out.append(slice(i * m, (i + 1) * m))
        return tuple(out)

    def local_spectral_slices(self, layout: str = "complex"):
        """This rank's slices of the global spectral axes (k0, k1, k2): of
        ``global_complex_shape()`` for ``layout="complex"``, of the packed
        pair's (N0, N1, N2/2) for ``"packed"``.  The solvers cut their 1-D
        wavenumbers, masks and weights with them."""
        return self._block_slices(self._global_shape(layout), layout,
                                  self.rank)

    def _global_shape(self, kind: str):
        if kind == "complex":
            return tuple(self.global_complex_shape())
        if kind == "packed":
            N = [int(n) for n in self.N]
            return tuple(N[:-1]) + (N[-1] // 2,)
        return tuple(int(n) for n in self.N)

    def _cut(self, a, kind: str):
        """This rank's block of a global ``kind`` array ``a`` (numpy or
        tensor, any leading axes)."""
        if self.P == 1:
            return a
        return a[(Ellipsis,) + self._block_slices(a.shape, kind, self.rank)]

    def _kind_of(self, local_shape):
        """(kind, global shape) of a local block of ``local_shape``: told
        apart by the shapes of this rank's blocks."""
        globs = [("real", tuple(int(n) for n in self.N)),
                 ("real", tuple(int(m) for m in self.M))
                 if hasattr(self, "M") else None,
                 ("complex", tuple(self.global_complex_shape())),
                 ("packed", self._global_shape("packed"))
                 if getattr(self, "_has_packed", False) else None]
        for kind, glob in filter(None, globs):
            blk = self._block_slices(glob, kind, self.rank)
            if tuple(local_shape) == tuple(s.stop - s.start for s in blk):
                return kind, glob
        raise ValueError(f"a local block of shape {tuple(local_shape)} is "
                         f"no block of this transform's fields")

    def shard_real(self, u) -> torch.Tensor:
        """This rank's block of a global physical-space array (any leading
        axes), as a tensor on ``self.device``."""
        return device_put(self._cut(u, "real"), self.float, self.device)

    def shard_complex(self, fu) -> torch.Tensor:
        """This rank's block of a global spectral array."""
        return device_put(self._cut(fu, "complex"), self.complex,
                          self.device)

    def gather(self, x) -> np.ndarray:
        """The global array of a local field (physical, spectral or a packed
        plane, told apart by its block's shape), as host numpy on every
        rank.  Host-facing: it gathers on the host over gloo (on the card
        with NCCL), every rank's block, placed by the block map."""
        if self.P == 1:
            return to_numpy(x)
        kind, glob = self._kind_of(x.shape[-self.ndim:])
        v = x.detach()
        if dist.get_backend(self.group) != "nccl":
            v = v.cpu()
        cplx = v.is_complex()
        if cplx:
            v = torch.view_as_real(v.contiguous())
        parts = collectives.all_gather(v.contiguous().unsqueeze(0),
                                       self.group, 0)
        parts = to_numpy(torch.view_as_complex(parts) if cplx else parts)
        out = np.empty(parts.shape[1:parts.ndim - self.ndim] + glob,
                       parts.dtype)
        for r in range(self.P):
            out[(Ellipsis,) + self._block_slices(glob, kind, r)] = parts[r]
        return out

    def zeros_real(self) -> torch.Tensor:
        return torch.zeros(self.real_shape(), dtype=self.float,
                           device=self.device)

    def zeros_complex(self) -> torch.Tensor:
        return torch.zeros(self.complex_shape(), dtype=self.complex,
                           device=self.device)

    # -- physical coordinates -----------------------------------------------------

    def _local_coords(self):
        """The 1-D physical coordinates of this rank's block (each axis
        starts where the block map puts it)."""
        d = (self.L / self.N).astype(np.float64)
        blk = self._block_slices(self.N, "real", self.rank)
        return tuple((b.start + torch.arange(int(n), dtype=self.float,
                                             device=self.device))
                     * _as_working(di, self.float)
                     for b, n, di in zip(blk, self.real_shape(), d))

    # -- the transpose stage ---------------------------------------------------------

    def _stage(self, x, split_axis: int, concat_axis: int, work_fn=None, *,
               pipeline_axis: int, pre_fn=None, ride=None):
        """One transpose stage, ``work_fn(transpose(pre_fn(x)))``, over the
        group ``ride`` (a ``(ProcessGroup, PeerGroup | None)`` pair; the
        transform's whole group when None; a None group is a world of one
        and skips the exchange), for a tensor or a tuple of them:
        ``communication`` "pipelined" chunks along ``pipeline_axis`` (a free
        axis), "rdma" runs row 23 (``parallel.rdma.rdma_all_to_all``;
        float32 leaves only: a complex leaf raises ``ValueError``, as in the
        reference), the others one ``all_to_all_single`` a leaf."""
        group, peers = ride or (self.group, self._peers)
        if group is not None and self.communication == "pipelined":
            return collectives.transpose_pipelined(
                x, group, split_axis, concat_axis, work_fn,
                pipeline_axis, nchunks=self._nchunks, pre_fn=pre_fn)
        if pre_fn is not None:
            x = pre_fn(x)
        if group is not None:
            if peers is not None:
                from .parallel.rdma import rdma_all_to_all
                x = rdma_all_to_all(x, peers, split_axis, concat_axis)
            else:
                x = collectives.transpose(x, group, split_axis, concat_axis)
        return work_fn(x) if work_fn is not None else x

    def _all_gather(self, x, axis: int, ride=None):
        """The tiled all-gather along ``axis`` over ``ride`` (the whole
        group when None): row 23 under "rdma" on the card, the group's
        ``all_gather`` otherwise."""
        group, peers = ride or (self.group, self._peers)
        if peers is not None:
            from .parallel.rdma import rdma_all_gather
            return rdma_all_gather(x, peers, axis)
        return collectives.all_gather(x, group, axis)

    def _all_reduce(self, t, ride=None):
        """The sum of a (scalar) tensor over ``ride`` (the whole group when
        None)."""
        return collectives.all_reduce(t, (ride or (self.group,))[0])

    def _flipconj_plane(self, qr, qi, ride, cut, axis: int = -1):
        """conj(Q(−k0, −k1)) of a planar (…, A, B) plane whose ``axis`` (−2
        or −1) is cut into ``cut`` = (parts, index) blocks over ``ride``:
        gather the plane (1/h of the field), flip it, keep this rank's
        block (the reference's ``_flipconj_plane_dist``)."""
        from .ops.fft3d import _flipconj
        parts, index = cut
        if parts == 1:
            return _flipconj(qr, qi, (-2, -1))
        gr, gi = self._all_gather((qr.contiguous(), qi.contiguous()), axis,
                                  ride)
        fr, fi = _flipconj(gr, gi, (-2, -1))
        n = qr.shape[axis]
        return fr.narrow(axis, index * n, n), fi.narrow(axis, index * n, n)

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
