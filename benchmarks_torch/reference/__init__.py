"""The plain references that decide ``correct``: float64 ``torch.fft``
(cuFFT on the card), written from the equations and the layouts'
definitions.  Nothing here imports the program, JAX or the JAX package.

``precision="tf32"`` computes the same in float32 with every transform's
input rounded to TF32 (10-bit mantissa), the precision of a tensor-core
DFT: the control that a sound comparison has to fail.
"""

import torch


def tf32_round(x):
    """``x`` (float32 or complex64) rounded to the nearest TF32 value,
    ties to even, kept in float32."""
    if x.is_complex():
        return torch.view_as_complex(tf32_round(torch.view_as_real(x)))
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def dtypes(precision):
    """(real dtype, complex dtype, input rounding) of a precision."""
    if precision == "float64":
        return torch.float64, torch.complex128, None
    if precision == "tf32":
        return torch.float32, torch.complex64, tf32_round
    raise ValueError(f"precision must be 'float64' or 'tf32', got "
                     f"{precision!r}")
