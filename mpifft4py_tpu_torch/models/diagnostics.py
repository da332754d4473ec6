"""Spectral diagnostics of DNS runs: shell-binned energy spectra, dissipation.

Port of ``mpifft4py_tpu/models/diagnostics.py``: E(k) shell sums over the
r2c spectrum with Hermitian weights (interior k2 modes count twice),
computed on the state's device, for the complex state and for the packed
(Sr, Si) pair (``*_packed``, from 1-D wavenumbers, with no complex or
K-mesh materialised).  At P > 1 each rank bins its own block and the
shells (and the dissipation) are summed over the group.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import spectral


def _hermitian_weights(FFT) -> torch.Tensor:
    """Weights over this rank's block of the last spectral axis: 1 for
    k2 = 0 and Nyquist, 2 for the interior (r2c layout), 0 for the
    pencil's alignment lanes k2 >= Nf (structural zeros)."""
    nfp = FFT.global_complex_shape()[-1]
    k = np.arange(nfp)
    w = np.where((k == 0) | (k == int(FFT.N[-1]) // 2), 1.0, 2.0)
    w[k >= int(FFT.N[-1]) // 2 + 1] = 0.0
    w = w[FFT.local_spectral_slices("complex")[-1]]
    return torch.as_tensor(w, dtype=torch.float32, device=FFT.device)


def energy_spectrum(FFT, U_hat) -> np.ndarray:
    """Shell-binned kinetic-energy spectrum E(k), k = 0..kmax, of a
    ``(C,) + global_complex_shape()`` spectral velocity; Σ E(k) is the mean
    kinetic energy (Parseval).  Returns a host numpy array."""
    K = FFT.get_local_wavenumbermesh()
    kmax = int(np.max(FFT.N) // 2)
    ntot = float(np.prod([int(n) for n in FFT.N]))
    kmag = torch.sqrt(torch.sum(K * K, dim=0))
    shell = torch.clamp(torch.round(kmag).to(torch.int64), 0, kmax)
    e = (0.5 * torch.sum(U_hat.abs() ** 2, dim=0) * _hermitian_weights(FFT)
         / (ntot * ntot))
    out = torch.zeros(kmax + 1, dtype=e.dtype, device=e.device)
    out.index_add_(0, shell.ravel(), e.ravel())
    return FFT._all_reduce(out).cpu().numpy()


def dissipation(FFT, U_hat, nu: float) -> float:
    """ε = 2ν Σ k² E(k) (physical wavenumbers)."""
    K = FFT.get_scaled_local_wavenumbermesh()
    ntot = float(np.prod([int(n) for n in FFT.N]))
    k2 = torch.sum(K * K, dim=0)
    e = (torch.sum(U_hat.abs() ** 2, dim=0) * _hermitian_weights(FFT)
         / (ntot * ntot))
    return float(FFT._all_reduce(nu * torch.sum(k2 * e)))


def _packed_ksq(FFT, L):
    """|K|² over this rank's packed block (integer wavenumbers for
    ``L=None``)."""
    return spectral.ksq(*spectral.factored_wavenumbers(
        FFT.N, L, int(FFT.N[2]) // 2, device=FFT.device,
        slices=FFT.local_spectral_slices("packed")))


def energy_spectrum_packed(FFT, pair) -> np.ndarray:
    """E(k) of a packed (Sr, Si) state (a pair or a (2, C, …) tensor), with
    no complex unpack.  The pair must be purified (2/3-rule solver states
    always are).  Returns a host numpy array."""
    sr, si = pair
    N = [int(n) for n in FFT.N]
    kmax = int(max(N) // 2)
    ntot = float(np.prod(N))
    w = spectral.packed_hermitian_weights(N, FFT.device)
    shell = torch.clamp(torch.round(torch.sqrt(_packed_ksq(FFT, None)))
                        .to(torch.int64), 0, kmax)
    e = 0.5 * torch.sum(sr * sr + si * si, dim=0) * w / (ntot * ntot)
    out = torch.zeros(kmax + 1, dtype=e.dtype, device=e.device)
    out.index_add_(0, shell.ravel(), e.ravel())
    return FFT._all_reduce(out).cpu().numpy()


def dissipation_packed(FFT, pair, nu: float) -> float:
    """ε of a packed (Sr, Si) state, from scaled 1-D wavenumbers."""
    sr, si = pair
    ntot = float(np.prod([int(n) for n in FFT.N]))
    w = spectral.packed_hermitian_weights(FFT.N, FFT.device)
    e = torch.sum(sr * sr + si * si, dim=0) * w / (ntot * ntot)
    return float(FFT._all_reduce(nu * torch.sum(_packed_ksq(FFT, FFT.L) * e)))
