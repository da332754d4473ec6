"""Consumer models: pseudo-spectral DNS solvers on the transform classes."""

from .boussinesq import Boussinesq3D  # noqa: F401
from .mhd import MHD3D  # noqa: F401
from .navier_stokes import INTEGRATORS, NavierStokes3D, SpectralSolver  # noqa: F401
from .navier_stokes_2d import NavierStokes2D  # noqa: F401
from .vv import VorticityVelocity3D  # noqa: F401
