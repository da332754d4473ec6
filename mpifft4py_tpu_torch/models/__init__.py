"""Consumer models: pseudo-spectral DNS solvers on the transform classes."""

from .navier_stokes import INTEGRATORS, NavierStokes3D, SpectralSolver  # noqa: F401
