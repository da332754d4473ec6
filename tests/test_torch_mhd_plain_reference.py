"""The port's MHD3D against the benchmark's plain float64 MHD reference
(``benchmarks_torch/reference/mhd.py``, torch only), and its two spans.

From one seeded random solenoidal (u, b) state under the 2/3 rule, 3 RK4
steps of the port and of the reference: the complex layout in float64 at
(16, 16, 32), the packed layout in float32 at (16, 16, 256) (the packed
gate needs (N2/2) % 128 == 0).  With b = 0 both solvers' velocity steps as
the reference's NS3D (``reference/ns3d.py``) and b stays 0.  The spans
``mpifft.solver.momentum`` and ``.induction`` open once a right-hand side,
4 a step under RK4, in both layouts.  No JAX here.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

from mpifft4py_tpu_torch import slab
from mpifft4py_tpu_torch.models import MHD3D
from mpifft4py_tpu_torch.utils import profiling

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks_torch")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from reference.mhd import MHD  # noqa: E402
from reference.ns3d import NS3D  # noqa: E402

TAU = 2 * math.pi
NC = (16, 16, 32)        # the complex layout
NP = (16, 16, 256)       # the packed layout
KW = dict(nu=0.01, eta=0.02, dt=0.01)
STEPS = 3
# float64 against float64: the two differ only in how their transforms
# sum, ~1e-16 a transform (6e-17 read over the 3 steps); 1e-13 leaves
# room for another FFT library's order of sums, and the reference in TF32
# reads 2e-7
TOL64 = 1e-13
# float32 against float64: float32's rounding of the state and of each
# transform's sums (6e-8 a rounding) over 3 steps read 1.8e-7; 1e-6
# leaves five times that
TOL32 = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(N, cls=MHD):
    kw = dict(KW) if cls is MHD else {"nu": KW["nu"], "dt": KW["dt"]}
    return cls(N, [TAU] * 3, dealias="2/3-rule", precision="float64",
               device="cpu", **kw)


def _state(ref, seed=3, b=True):
    """A seeded random (û, b̂) of unit scale: both fields solenoidal,
    2/3-rule masked, of real fields (complex128 (6, N0, N1, N2/2 + 1))."""
    g = torch.Generator().manual_seed(seed)
    S = torch.fft.rfftn(torch.randn((6,) + ref.N, generator=g,
                                    dtype=torch.float64), dim=(1, 2, 3))
    K = ref.K
    for f in (S[:3], S[3:]):
        div = (K[0] * f[0] + K[1] * f[1] + K[2] * f[2]) / torch.where(
            ref.ksq == 0, 1.0, ref.ksq)
        for c in range(3):
            f[c] -= K[c] * div
    S = S * ref.mask
    if not b:
        S[3:] = 0
    return S / S.abs().max()


def _solver(N, precision, layout):
    FFT = slab.R2C(np.array(N), np.array([TAU] * 3), None, precision,
                   device="cpu")
    return MHD3D(FFT, dealias="2/3-rule", integrator="RK4",
                 spectral_layout=layout, **KW)


def _port_steps(S, layout, n=STEPS):
    """The port's ``n`` RK4 steps from the complex128 state ``S``: complex
    in float64, packed in float32; the result as complex128."""
    N = (S.shape[1], S.shape[2], 2 * (S.shape[3] - 1))
    if layout == "complex":
        s = _solver(N, "double", "complex")
        return s.run(S, n)
    s = _solver(N, "single", "packed")
    out = s.run(s.to_packed(S.to(torch.complex64)), n)
    return s.from_packed(out).to(torch.complex128)


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("layout,N,tol", [("complex", NC, TOL64),
                                          ("packed", NP, TOL32)])
def test_steps_match_plain_reference(layout, N, tol):
    ref = _reference(N)
    S = _state(ref)
    if layout == "packed":      # the reference starts where float32 does
        S = S.to(torch.complex64).to(torch.complex128)
    want, _ = ref.run(S, STEPS, STEPS)
    got = _port_steps(S, layout)
    assert _gap(got[:3], want[:3]) <= tol
    assert _gap(got[3:], want[3:]) <= tol
    # the step is not the identity at this tolerance
    assert _gap(S, want) > 100 * tol


@pytest.mark.parametrize("layout,N,tol", [("complex", NC, TOL64),
                                          ("packed", NP, TOL32)])
def test_zero_field_matches_ns3d_reference(layout, N, tol):
    """b = 0: the momentum is NS3D's, and b stays exactly 0."""
    S = _state(_reference(N), b=False)
    if layout == "packed":
        S = S.to(torch.complex64).to(torch.complex128)
    ns, _ = _reference(N, NS3D).run(S[:3], STEPS, STEPS)
    mhd, _ = _reference(N).run(S, STEPS, STEPS)
    assert _gap(mhd[:3], ns) <= 1e-14
    assert float(mhd[3:].abs().max()) == 0.0
    got = _port_steps(S, layout)
    assert _gap(got[:3], ns) <= tol
    assert float(got[3:].abs().max()) == 0.0


@pytest.mark.parametrize("layout,N", [("complex", NC), ("packed", NP)])
def test_momentum_and_induction_spans(layout, N):
    """One span of each half a right-hand side: 4 a step under RK4."""
    s = _solver(N, "single", layout)
    UB = s.taylor_green_mhd()
    profiling.reset()
    profiling.enable()
    try:
        s.run(UB, 2)
    finally:
        profiling.disable()
    spans = profiling.report()
    profiling.reset()
    assert spans["mpifft.solver.step"]["count"] == 2
    for name in ("mpifft.solver.momentum", "mpifft.solver.induction"):
        assert spans[name]["count"] == 8
        # each holds its forward transform
        assert spans[name]["host_s"] > spans[name]["self_host_s"]
