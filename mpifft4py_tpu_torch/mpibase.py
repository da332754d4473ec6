"""Precision policy and scratch arrays.

Port of ``mpifft4py_tpu/mpibase.py``.  ``"single"`` is float32/complex64 and
``"double"`` float64/complex128 on every device: the card has native fp64,
so the reference's doubleword emulation (which exists only because the TPU
lacks it) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["DTypePolicy", "resolve_precision", "datatypes", "work_arrays"]


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Resolved numeric policy of one transform object.

    Attributes:
      precision: the requested string, "single" or "double".
      float: torch dtype of physical-space fields.
      complex: torch dtype of spectral-space fields.
    """

    precision: str
    float: torch.dtype
    complex: torch.dtype


def resolve_precision(precision: str) -> DTypePolicy:
    if precision == "single":
        return DTypePolicy("single", torch.float32, torch.complex64)
    if precision == "double":
        return DTypePolicy("double", torch.float64, torch.complex128)
    raise ValueError(f"precision must be 'single' or 'double', got {precision!r}")


def datatypes(precision: str) -> Tuple[torch.dtype, torch.dtype, torch.dtype]:
    """(float, complex, complex): the reference's third slot names the dtype
    the collectives move, which is the complex dtype."""
    pol = resolve_precision(precision)
    return (pol.float, pol.complex, pol.complex)


class work_arrays(dict):
    """Cached zero-filled scratch tensors, keyed like mpiFFT4py's
    ``work_arrays``: ``(shape, dtype, index[, ...])`` or
    ``(prototype_tensor, index[, ...])``, allocated on ``device`` at first use.
    """

    def __init__(self, device="cpu"):
        super().__init__()
        self.device = torch.device(device)

    @staticmethod
    def _normalize(key):
        first = key[0]
        if isinstance(first, torch.Tensor):
            return (tuple(first.shape), first.dtype) + tuple(key[1:])
        return (tuple(first), key[1]) + tuple(key[2:])

    def __getitem__(self, key):
        return super().__getitem__(self._normalize(key))

    def __missing__(self, key):
        a = torch.zeros(key[0], dtype=key[1], device=self.device)
        self[key] = a
        return a
