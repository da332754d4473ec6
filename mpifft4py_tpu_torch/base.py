"""Shared machinery of the transform classes, on one device.

Port of ``mpifft4py_tpu/base.py`` at P == 1.  A transform object owns its
grid, its precision policy and an explicit ``device``; its transforms are
plain functions on tensors, cached per key in ``self._plans`` (the FFTW
plan's role; PyTorch runs eagerly, so nothing is compiled).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .mpibase import DTypePolicy, resolve_precision, work_arrays
from .utils.transfer import device_put, to_numpy

_DIST_ITEM = "ROADMAP.md queue 1 item 8 (distributed transforms)"

DEALIAS = (None, "2/3-rule", "3/2-rule")


def _as_working(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as the reference's
    ``np.asarray(...).astype(FFT.float)`` constants are."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


class BaseFFT:
    """Constructor and bookkeeping shared by the transforms.

    The signature mirrors the reference, ``R2C(N, L, comm, precision, ...)``,
    plus ``device=`` (default ``"cuda"``; a missing card raises, it never
    turns into the CPU).  ``comm`` must be ``None`` or ``1``: the
    distributed transforms are not ported yet.  ``threads`` and
    ``planner_effort`` are accepted for compatibility and ignored.
    """

    ndim: int = 3

    def __init__(self, N, L, comm=None, precision: str = "single", *,
                 communication: str = "Alltoall", padsize: float = 1.5,
                 threads=None, planner_effort=None, device="cuda"):
        del threads, planner_effort
        if comm not in (None, 1):
            raise NotImplementedError(
                f"comm={comm!r}: only one device (comm=None or 1) is ported; "
                f"see {_DIST_ITEM}")
        if communication not in ("Alltoall", "Alltoallw", "alltoall"):
            raise NotImplementedError(
                f"communication={communication!r}: see {_DIST_ITEM}")
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
        self.P = 1
        self.rank = 0
        self.work_arrays = work_arrays(self.device)
        self._plans: Dict[Tuple, Callable] = {}
        self._validate()

    def _validate(self) -> None:
        raise NotImplementedError

    # -- field placement ------------------------------------------------------

    def shard_real(self, u) -> torch.Tensor:
        """A host array as a physical-space field on ``self.device``."""
        return device_put(u, self.float, self.device)

    def shard_complex(self, fu) -> torch.Tensor:
        return device_put(fu, self.complex, self.device)

    def gather(self, x) -> np.ndarray:
        return to_numpy(x)

    # -- physical coordinates -----------------------------------------------------

    def _local_coords(self):
        """The 1-D physical coordinates of the mesh's axes."""
        d = (self.L / self.N).astype(np.float64)
        return tuple(torch.arange(int(n), dtype=self.float, device=self.device)
                     * _as_working(di, self.float) for n, di in zip(self.N, d))

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
