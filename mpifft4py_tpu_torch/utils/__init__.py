"""Spectral utilities and host/device transfer helpers."""

from .spectral import (  # noqa: F401
    pad_full_axis, trunc_full_axis, pad_half_axis, trunc_half_axis,
    flip_conj_plane, wavenumbers_full, wavenumbers_half, dealias_cutoffs,
    factored_wavenumbers, packed_dealias_masks, packed_hermitian_weights, ksq,
)
