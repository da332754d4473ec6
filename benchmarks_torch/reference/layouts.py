"""The program's spectral layouts, from their definitions, as the r2c
layout's complex spectrum (N0, N1, N2/2 + 1).

The packed layout keeps N2/2 columns as a planar pair, ``[0]`` the real
and ``[1]`` the imaginary plane; column 0 carries Q = X0 + i·X_Nyq, so
X0 = (Q + conj Q(−k))/2 and X_Nyq = (Q − conj Q(−k))/(2i) over the
(k0, k1) plane."""

import torch

from .ns3d import flipconj


def packed_to_complex(S, dtype=torch.complex128):
    """A packed state (2, C, N0, N1, h) -> complex (C, N0, N1, h + 1)."""
    z = torch.complex(S[0].to(torch.float64), S[1].to(torch.float64))
    out = torch.empty(z.shape[:-1] + (z.shape[-1] + 1,), dtype=dtype,
                      device=z.device)
    for c in range(z.shape[0]):
        q = z[c, ..., 0]
        qf = flipconj(q)
        out[c, ..., 0] = 0.5 * (q + qf)
        out[c, ..., -1] = (q - qf) / 2j
        out[c, ..., 1:-1] = z[c, ..., 1:]
    return out


def to_complex(S, dtype=torch.complex128):
    """A state in either layout -> the complex layout in ``dtype``."""
    if S.is_complex():
        return S.to(dtype)
    return packed_to_complex(S, dtype)
