"""Serial FFTs (the L1 tier).

Counterpart of ``mpifft4py_tpu/serialFFT/``: the reference exports its
``xla_fft`` surface (``jnp.fft`` wrappers, with ``rfftn``/``irfftn`` routed
to the Pallas 3D chain on the TPU); the port exports ``torch_fft``
(``torch.fft`` wrappers, with ``rfftn``/``irfftn`` routed to the
hand-written 3D chain of ``ops.fft3d``) and the even-extension ``dct``/
``idct`` of ``dct.py``.
"""

from .torch_fft import (  # noqa: F401
    fft, ifft, fft2, ifft2, fftn, ifftn,
    rfft, irfft, rfft2, irfft2, rfftn, irfftn,
    dct, idct,
)
