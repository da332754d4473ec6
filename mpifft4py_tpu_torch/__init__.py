"""mpifft4py_tpu_torch — the PyTorch/CUDA port of ``mpifft4py_tpu``.

Distributed-FFT library and pseudo-spectral solvers on an NVIDIA H100, with
hand-written CUDA kernels where the JAX package has Pallas kernels.  The JAX
package stays the reference; the port keeps its module names.  Ported so far
(one device): ``slab.R2C`` and ``slab.C2C`` with ``dealias=None`` /
``"2/3-rule"`` / ``"3/2-rule"``, the packed interface of ``R2C``
(``forward_packed_fn``/``backward_packed_fn``), and the 3D solvers
``models.NavierStokes3D``, ``models.VorticityVelocity3D``, ``models.MHD3D``
and ``models.Boussinesq3D`` in the complex and the packed layout (the
complex layout also with the 3/2 rule).

    from mpifft4py_tpu_torch.slab import R2C, C2C
    from mpifft4py_tpu_torch.models import MHD3D, NavierStokes3D
    FFT = R2C(N, L, None, "single", device="cuda")
    solver = NavierStokes3D(FFT, nu, dt, spectral_layout="packed")
    state = solver.run(solver.taylor_green(), 10)   # (2, 3, N0, N1, N2/2)
    padded = NavierStokes3D(FFT, nu, dt, dealias="3/2-rule")
    mhd = MHD3D(FFT, nu, eta, dt, spectral_layout="packed")
    UB = mhd.run(mhd.taylor_green_mhd(), 10)        # (2, 6, N0, N1, N2/2)

Tests: ``python -m pytest tests/test_torch_*.py -q`` on the CPU (the packed
layout in ``tests/test_torch_packed.py``, the 3/2 rule in
``tests/test_torch_padded.py``, ``C2C`` in ``tests/test_torch_c2c.py``,
the solver family in ``tests/test_torch_{vv,mhd,boussinesq}.py``);
``python3 chip_smoke.py`` on the card, and ``python3 profile_step.py`` for
the steps' times and profiles.
"""

__version__ = "0.1.0"

from .mpibase import datatypes, work_arrays, resolve_precision, DTypePolicy  # noqa: F401
from .utils.transfer import (to_numpy, device_put, state_from_reference,  # noqa: F401
                             packed_state_from_reference)
