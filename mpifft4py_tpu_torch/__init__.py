"""mpifft4py_tpu_torch — the PyTorch/CUDA port of ``mpifft4py_tpu``.

Distributed-FFT library and pseudo-spectral solvers on an NVIDIA H100, with
hand-written CUDA kernels where the JAX package has Pallas kernels.  The JAX
package stays the reference; the port keeps its module names.  Ported so far
(one device): ``slab.R2C`` and ``slab.C2C`` with ``dealias=None`` /
``"2/3-rule"`` / ``"3/2-rule"``, the packed interface of ``R2C``
(``forward_packed_fn``/``backward_packed_fn``), and the 3D solvers
``models.NavierStokes3D``, ``models.VorticityVelocity3D``, ``models.MHD3D``
and ``models.Boussinesq3D`` in the complex and the packed layout (the
complex layout also with the 3/2 rule), ``line.R2C`` (2D, dealias None /
2/3 / 3/2) and ``models.NavierStokes2D`` in the complex and the packed
layout (the packed 2D layout in the reference's DIF lane order at N1 ∈
{512, 768, 1024}), and the serial tier: ``fft`` … ``irfftn``, ``dct``/
``idct`` (``serialFFT``, over ``torch.fft``, with ``rfftn``/``irfftn`` on the
hand-written 3D chain inside the kernels' envelope) and the dense per-axis
kernels of ``ops.dense``.  The kernels take every grid the reference's
kernels take (``ops.fft3d.supported_c2c``/``supported_r2c``).

At P > 1 (a ``torch.distributed`` group, one process a rank: ``comm=None``
takes the initialised default group) ``slab.R2C`` and ``slab.C2C`` cut
physical space along axis 0 and spectral space along axis 1;
``pencil.R2C`` and ``pencil.C2C`` cut two axes on a P1×P2 grid of ranks
(``P1=``, ``alignment="X"``/``"Y"``, the two sub-groups of
``parallel.mesh.pencil_groups``; the packed interface at P2 == 1 and in
the WIDE layout at P2 > 1).  Both take every ``dealias`` and
``NavierStokes3D`` steps on both in both layouts; ``communication`` is
"alltoall"/"pipelined" (the group's ``all_to_all_single``, NCCL on the
card) or "rdma" (the hand-written peer-memory kernels of
``parallel.rdma``, rows 23–27: P processes may share one card over a gloo
group).  The rest of the family and ``line`` wait at P > 1 (ROADMAP.md
queue 1 item 5).

    from mpifft4py_tpu_torch.slab import R2C, C2C
    from mpifft4py_tpu_torch.models import MHD3D, NavierStokes2D, NavierStokes3D
    FFT = R2C(N, L, None, "single", device="cuda")
    solver = NavierStokes3D(FFT, nu, dt, spectral_layout="packed")
    state = solver.run(solver.taylor_green(), 10)   # (2, 3, N0, N1, N2/2)
    padded = NavierStokes3D(FFT, nu, dt, dealias="3/2-rule")
    mhd = MHD3D(FFT, nu, eta, dt, spectral_layout="packed")
    UB = mhd.run(mhd.taylor_green_mhd(), 10)        # (2, 6, N0, N1, N2/2)
    from mpifft4py_tpu_torch.line import R2C as R2C2D
    ns2d = NavierStokes2D(R2C2D((1024, 1024), (TAU, TAU)), nu, dt,
                          spectral_layout="packed")
    w = ns2d.run(ns2d.vortex_pair(), 10)            # (2, 1024, 512)
    from mpifft4py_tpu_torch import rfftn, irfftn, dct, zeros
    u = zeros((640, 640, 640), np.float32)          # on the card
    u_hat = rfftn(u)                                # (640, 640, 321)
    # P ranks (torchrun --nproc-per-node=P), each on its own card:
    from mpifft4py_tpu_torch.parallel import runtime
    runtime.initialize()                            # NCCL, LOCAL_RANK's card
    FFT = R2C(N, L, None, "single")                 # (N0/P, N1, N2) a rank
    from mpifft4py_tpu_torch import pencil          # a 2 x P/2 grid:
    FFT = pencil.R2C(N, L, None, "single", P1=2, communication="rdma")

``save_field``/``load_field``/``save_state``/``load_state`` of the
reference's package surface are not ported yet (ROADMAP.md queue 1 item 2).

Tests: ``python -m pytest tests/test_torch_*.py -q`` on the CPU (the packed
layout in ``tests/test_torch_packed.py``, the 3/2 rule in
``tests/test_torch_padded.py``, ``C2C`` in ``tests/test_torch_c2c.py``,
the solver family in ``tests/test_torch_{vv,mhd,boussinesq}.py``, the 2D
family in ``tests/test_torch_ns2d.py``, the envelope in
``tests/test_torch_envelope.py``, the dense tier in
``tests/test_torch_dense.py`` and the serial tier in
``tests/test_torch_serial_fft.py``, the slab at P > 1 in
``tests/test_torch_slab_dist.py`` and the pencil in
``tests/test_torch_pencil.py`` and ``tests/test_torch_pencil_dist.py``,
over pools of gloo ranks);
``python3 chip_smoke.py`` on the card, and ``python3 profile_step.py`` for
the steps' times and profiles.
"""

__version__ = "0.1.0"

from .mpibase import datatypes, work_arrays, resolve_precision, DTypePolicy  # noqa: F401
from .utils.transfer import (to_numpy, device_put, state_from_reference,  # noqa: F401
                             packed_state_from_reference)
from .serialFFT import (  # noqa: F401,E402
    fft, ifft, fft2, ifft2, fftn, ifftn,
    rfft, irfft, rfft2, irfft2, rfftn, irfftn,
    dct, idct,
)
from . import line, parallel, pencil, slab  # noqa: F401,E402
from .models import (Boussinesq3D, MHD3D, NavierStokes2D,  # noqa: F401,E402
                     NavierStokes3D, VorticityVelocity3D)


def zeros(shape, dtype=float, device="cuda"):
    """A tensor of zeros of ``shape`` and ``dtype`` (a numpy or torch
    dtype; ``float`` is float64, as in the reference) on ``device``: the
    card unless the caller asks for the CPU."""
    import torch
    from .utils.transfer import _torch_dtype
    return torch.zeros(tuple(shape), dtype=_torch_dtype(dtype), device=device)


def empty(shape, dtype=float, device="cuda"):
    """Reference-parity allocation: zeros, as the reference's ``empty``
    (an uninitialised tensor would differ from it)."""
    return zeros(shape, dtype, device)
