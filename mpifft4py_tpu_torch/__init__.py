"""mpifft4py_tpu_torch — the PyTorch/CUDA port of ``mpifft4py_tpu``.

Distributed-FFT library and pseudo-spectral solvers on an NVIDIA H100, with
hand-written CUDA kernels where the JAX package has Pallas kernels.  The JAX
package stays the reference; the port keeps its module names.  Ported so far
(one device): ``slab.R2C`` with ``dealias=None`` / ``"2/3-rule"`` and
``models.NavierStokes3D`` in the complex layout.

    from mpifft4py_tpu_torch.slab import R2C
    FFT = R2C(N, L, None, "single", device="cuda")
"""

__version__ = "0.1.0"

from .mpibase import datatypes, work_arrays, resolve_precision, DTypePolicy  # noqa: F401
from .utils.transfer import to_numpy, device_put, state_from_reference  # noqa: F401
