"""Host ↔ device transfer helpers.

Counterpart of ``mpifft4py_tpu/utils/transfer.py``.  CUDA moves complex
tensors whole, so these are thin; ``state_from_reference`` and
``packed_state_from_reference`` hand a solver state from the JAX package to
the port so both step the identical state.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["device_put", "to_numpy", "state_from_reference",
           "packed_state_from_reference"]

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


def device_put(a, dtype, device) -> torch.Tensor:
    """A numpy array (or tensor) as a contiguous tensor of ``dtype`` on
    ``device``."""
    dtype = _torch_dtype(dtype)
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype).contiguous()


def to_numpy(x) -> np.ndarray:
    """A tensor on any device as a host numpy array."""
    return x.detach().cpu().numpy()


def state_from_reference(U_hat_np, FFT) -> torch.Tensor:
    """The JAX solver's complex spectral state, a numpy ``(C,) +
    FFT.global_complex_shape()`` array of FFT's complex dtype (a 2D FFT's
    state, NS2D's ω̂, has no component axis: ``FFT.global_complex_shape()``
    itself), as the port's tensor on ``FFT.device``: this rank's block
    (the slab's k1 block; the pencil's k1 and k2 blocks, within Nfp), so
    each rank of a group takes its part of the reference's state."""
    U = np.asarray(U_hat_np)
    want = tuple(FFT.global_complex_shape())
    lead = (U.shape[0],) if len(want) == 3 and U.ndim == 4 else ()
    if tuple(U.shape) != lead + want or (len(want) == 3 and not lead):
        raise ValueError(f"state shape {U.shape} is not "
                         f"{'(C,) + ' if len(want) == 3 else ''}{want}")
    if _NP_TO_TORCH.get(U.dtype) != FFT.complex:
        raise TypeError(f"state dtype {U.dtype} does not match {FFT.complex}")
    return device_put(FFT._cut(U, "complex"), FFT.complex, FFT.device)


def packed_state_from_reference(pair, FFT) -> torch.Tensor:
    """The JAX solver's packed state, a numpy float32 pair ``(Ur, Ui)`` of
    shape (C, N0, N1, N2/2) each, as the port's packed state: one
    (2, C, N0, N1, N2/2) tensor on ``FFT.device``.  The 3D pair must be in
    natural lane order (the reference's zdif order at N2 >= 512 is undone
    by the caller with ``zdif_iperm``).  For a 2D FFT (NS2D's packed
    layout) the pair is (N0, N1/2) each and the tensor (2, N0, N1/2), in
    the lane order both packages' NS2D keep (zdif order at N1 ∈ {512, 768,
    1024}).  At P > 1 the tensor is this rank's k1 block (over P1 for the
    pencil at P2 == 1, over P1·P2 in its WIDE layout)."""
    ur, ui = (np.asarray(a) for a in pair)
    N = [int(n) for n in FFT.N]
    want = tuple(N[:-1]) + (N[-1] // 2,)
    lead = ur.shape[:1] if len(N) == 3 and ur.ndim == 4 else ()
    if (ur.shape != ui.shape or tuple(ur.shape) != tuple(lead) + want
            or (len(N) == 3 and not lead)):
        raise ValueError(f"packed pair shapes {ur.shape}, {ui.shape} are not "
                         f"{'(C,) + ' if len(N) == 3 else ''}{want}")
    if ur.dtype != np.float32 or ui.dtype != np.float32:
        raise TypeError(f"packed pair dtypes {ur.dtype}, {ui.dtype}: float32 "
                        f"expected")
    return device_put(FFT._cut(np.stack([ur, ui]), "packed"), torch.float32,
                      FFT.device)
