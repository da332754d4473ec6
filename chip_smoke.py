#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mpifft4py_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each checked; any failed check makes the exit code non-zero:

0. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
1. build the CUDA kernels from ``mpifft4py_tpu_torch/ops/csrc`` (nvcc);
2. kernels: each hand-written kernel against its plain twin on the card,
   at the shapes of the 256³ and 512³ transforms, of the 256³ packed
   NS3D step and of the 256³ 3/2-rule and C2C transforms (C2C's 3/2 rule
   at 384³ on every axis), the cross kernel also at a 512-class plane
   (relative 1e-5), with each kernel's time beside its twin's; rows 10
   and 20 (``fft_last.cu``) also on views one row (n = 129) or one value
   into a larger buffer (bases off the bulk copies' 16-byte grid) and on
   201 rows (fewer tiles than the persistent grid has blocks), each also
   in a round trip (1e-6), and row 20 at n = 1021 and 2·509; rows 21 and
   8 (``planar_rfft.cu``'s persistent r2c) on inputs one value or one row
   into a buffer, on 201 rows and ragged 3-stacks, truncated to nf = 129
   on band-limited rows, and into widths 130 and 132 through ``out=`` (a
   pair that starts inside its buffer), each against its twin and in a
   round trip through the c2r (1e-6); rows 1 and 19 (``fft_axis.cu``) on
   inputs and ``out=`` views 1-3 values into larger buffers, with post =
   129, 130 and 3 and pre > 1, each against its twin and in a round trip
   (1e-6); the complex layout's pointwise right-hand side (``rhs_curl``,
   ``rhs_cross``, ``rhs_leray_visc``, port-only rows P1-P3) at the 256³
   complex step's shapes, the product also on the 3/2 rule's 384³ grid,
   against their eager twins at 1e-6;
3. transforms: ``slab.R2C`` at 256³ and 512³ against float64
   ``torch.fft.rfftn``, the round trip, the 2/3-rule forward, and the
   round-trip time beside ``torch.fft``'s;
4. solver: ``NavierStokes3D`` RK4 at 256³ from Taylor–Green, 5 steps,
   against the same run in ``precision="double"``;
5. packed solver: the same 5 steps with ``spectral_layout="packed"``,
   against the complex-layout float32 and float64 runs, with its ms per
   step and peak memory beside the complex layout's;
6. padded solver: the same 5 steps with ``dealias="3/2-rule"`` (the
   nonlinear term on the 384³ grid), against the same run in "double",
   beside the 2/3-rule complex step;
7. the solver family: ``VorticityVelocity3D``, ``MHD3D`` and
   ``Boussinesq3D`` at 256³, RK4 with the 2/3 rule, 5 steps in each layout,
   each float32 state against the same model's float64 complex run, VV
   against the curl of phase 4's NS3D states, MHD's ∇·b at round-off, with
   ms per step, peak step memory and each kernel's launches per step, and
   each packed step's launches of its right-hand side's kernels checked
   against 4 × the count of one right-hand side;
8. the 2D family: ``line.R2C`` at 1024² and 2048² in "single" and
   "double" (forwards against float64 ``torch.fft.rfft2``, round trips
   with ``dealias`` None, 2/3 and 3/2), then ``NavierStokes2D`` RK4 from
   the vortex pair, 5 steps: the packed layout at 1024² (rows 17–18 and
   ``fft_axis``, their exact launches a step checked) and the complex
   layout at 1024² and 2048², each against the float64 complex run, the
   packed state against the complex one, the enstrophy decaying, with ms
   per step (host clock and CUDA events) and peak step memory; then the
   same at 1024 x 2048 in both layouts (natural lanes, h = 1024);
9. ``serialFFT`` (``mpifft4py_tpu_torch.rfftn``/``irfftn``) at 640³ float32,
   through the hand-written chain (radix 5 on every axis): against float64
   ``torch.fft.rfftn``, the round trip, the launches, the time beside
   ``torch.fft``'s;
10. the dense tier (rows 19–22, ``ops.dense``) at 256³, composed as
    benchmarks/pallas_tuning.py composes it: ``rfft_last`` then
    ``fft_axis`` on y and x against float64 ``rfftn``, row 20 on the last
    axis of that spectrum, the round trip, the chain's time;
11. packed NS3D at (320, 320, 1280) (radix 5 on x, y and the packed
    z): 5 RK4 steps, the hand-written launches a step equal to the 256³
    packed step's, the energy decaying, the state against the complex
    layout's, ms per step and peak memory;
12. the distributed slab on one card: P = 2, then P = 4, ranks spawned
    on ``cuda:0`` with a gloo group (NCCL refuses two ranks on one card)
    and ``communication="rdma"`` (rows 23-25 over CUDA IPC): ``slab.R2C``
    256³ forward and round trip, the gathered spectrum against the P == 1
    kernel path (1e-6) and float64 ``torch.fft.rfftn`` (2e-6), the 2/3-rule
    forward and the 3/2-rule forward (row 23) against the P == 1 path,
    ``slab.C2C`` 256³ round trip; at P = 2 also 5 packed NS3D 256³ RK4
    steps from Taylor–Green, the energy decaying, each step's launches
    exactly 4 x one right-hand side's (``DIST_RHS``), the state against
    phase 5's P == 1 state (1e-5 relative L2); ms per round trip and per
    step with the share spent in the fences (synchronise + barrier).  The
    ranks time-slice one card: these are not scaling figures.  Each rank
    counts its own launches around each call, and they join the main
    path's counts;
13. the pencil on one card: 4 ranks spawned on ``cuda:0`` (gloo,
    ``communication="rdma"``, rows 23-27), the grids 2x2, 4x1 and 1x4 built
    from them: ``pencil.R2C`` 256³ on 2x2 against float64
    ``torch.fft.rfftn`` (2e-6, its alignment lanes exactly 0), its round
    trip, its 2/3-rule forward and its 3/2-rule forward and round trip
    against the P == 1 slab path (1e-6), the alignment-Y, ``pencil.C2C``
    and 1x4 round trips, the 4x1 packed interface's round trip, then 5
    NS3D 256³ RK4 steps on 2x2 in each layout (packed = WIDE) from
    Taylor–Green, each state against phase 4's/5's P == 1 state (1e-5 rel
    L2), the energy decaying, each step's launches exactly 4 x one
    right-hand side's (``PENCIL_COMPLEX_RHS``, ``PENCIL_PACKED_RHS``; rows
    26-27 in the complex steps); ms per round trip and per step with the
    fence share.

Before the main path, the envelope sweep holds the widened plans against
their twins (1e-5) and in round trips through the kernels (1e-6):
``fft_axis`` and ``fft_last`` at every ``supported_c2c`` n in 8..1024, the
packed r2c/c2r and the planar and dense r2c (rows 8 and 21; nf whole and
truncated, widths above nf) at every even n in 16..2048, and times them at
n = 40, 112, 640, 1016 (c2c) and 2042 (r2c) beside n = 1024 and 2048.

Phase 3 also runs the 3/2-rule transforms at 256³ (the padded round trip,
the forward of a product field against a float64 alias-sum oracle) and
``slab.C2C`` (forward against float64 ``torch.fft.fftn``, round trip, and
the 3/2-rule round trip and forward, the latter against float64 ``fftn``
on the 384³ grid truncated to 256³, and the 3/2-rule round trip's time;
its 384-point ``fft_last`` launches are the ``fft_last_384`` entry's).
Phases 3–13 are the main path: each runs with the kernels' launch counters
set to 0 just before it and read just after, and phases 4–8 also read them
around each of their steps.  Phase 2 also holds each template variant of
the fused kernels (Biot–Savart curl, cross2 and mul products, the curl,
div and buoyancy epilogues) against its twin at the 256³ shapes of the
solvers' right-hand sides, and rows 17–18 (the DIF lane order of the
packed 2D layout) at n = 512, 768 and 1024 on the 1024² field and the
(4, 1024, n/2) stack of NS2D's batched inverse, against their twins (and
row 17 against row 4 permuted, and a round trip) at 1e-6, and rows 19–22
at the 256³ chain's shapes and the full-length r2c/c2r at odd n, and
rows 23-27 with in-process buffer tables at P = 2 and 4 (P ranks emulated
by one launch each) at phase 12's and 13's 256³ shapes.  Each kernel's
time is its median beside its plain twin's and, where one exists, one ``torch.fft`` call's computing the
same function, with the bound of its bytes at 3.35 TB/s and of its FFT
flops (5 n log2 n a complex transform, half that a real one) at 67 TFLOP/s
FP32.  The second-to-last line is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""

import gc
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TAU = 2 * np.pi
SEED = 0
QTIMEOUT = 600          # seconds phase 12 waits for a rank's result

PALLAS = "mpifft4py_tpu/ops/pallas_fft3d.py"
DENSE = "mpifft4py_tpu/ops/pallas_fft.py"
RDMA = "mpifft4py_tpu/parallel/rdma.py"
CSRC = "mpifft4py_tpu_torch/ops/csrc"
KERNELS = {
    # name: (source, Pallas kernel(s) it replaces, with their row in PERF.md)
    "fft_axis": (f"{CSRC}/fft_axis.cu", f"{PALLAS}:330 (row 1)"),
    "packed_rfft_last": (f"{CSRC}/planar_rfft.cu", f"{PALLAS}:636 (row 4)"),
    "packed_irfft_last": (f"{CSRC}/packed_rfft.cu", f"{PALLAS}:849 (row 5)"),
    "curl_ifft_x": (f"{CSRC}/curl_ifft_x.cu", f"{PALLAS}:1378 (row 11)"),
    "curl_ifft_x_biot_savart": (f"{CSRC}/curl_ifft_x.cu",
                                f"{PALLAS}:1378 (row 11, biot_savart)"),
    "cross_rfft_z": (f"{CSRC}/cross_rfft_z.cu",
                     f"{PALLAS}:1805 (row 12); {PALLAS}:1755 (row 13); "
                     f"{PALLAS}:2141 (row 16)"),
    "cross2_rfft_z": (f"{CSRC}/cross_rfft_z.cu",
                      f"{PALLAS}:1805 (row 12, cross2); {PALLAS}:2141 "
                      f"(row 16, cross2)"),
    "mul_rfft_z": (f"{CSRC}/cross_rfft_z.cu",
                   f"{PALLAS}:2033 (row 15); {PALLAS}:1755 (row 13, mul); "
                   f"{PALLAS}:2141 (row 16, mul)"),
    "fft_x_epilogue": (f"{CSRC}/fft_x_epilogue.cu",
                       f"{PALLAS}:1981 (row 14)"),
    "fft_x_epilogue_buoy": (f"{CSRC}/fft_x_epilogue.cu",
                            f"{PALLAS}:1981 (row 14, buoy)"),
    "fft_x_epilogue_curl": (f"{CSRC}/fft_x_epilogue.cu",
                            f"{PALLAS}:1981 (row 14, mode curl)"),
    "fft_x_epilogue_div": (f"{CSRC}/fft_x_epilogue.cu",
                           f"{PALLAS}:1981 (row 14, mode div)"),
    "planar_rfft_last": (f"{CSRC}/planar_rfft.cu", f"{PALLAS}:439 (row 8)"),
    "planar_irfft_last": (f"{CSRC}/planar_rfft.cu", f"{PALLAS}:477 (row 9)"),
    "fft_last": (f"{CSRC}/fft_last.cu", f"{PALLAS}:531 (row 10)"),
    # row 10 at the 3/2-rule C2C's 384-point rows (launches: that path's)
    "fft_last_384": (f"{CSRC}/fft_last.cu",
                     f"{PALLAS}:531 (row 10, n = 384 with scale)"),
    "packed_rfft_last_zdif": (f"{CSRC}/planar_rfft.cu",
                              "mpifft4py_tpu/ops/pallas_zdif.py:387 (row 17)"),
    "packed_irfft_last_zdif": (f"{CSRC}/packed_rfft.cu",
                               "mpifft4py_tpu/ops/pallas_zdif.py:415 "
                               "(row 18)"),
    "dense_fft_axis": (f"{CSRC}/fft_axis.cu",
                       f"{DENSE}:97 (row 19, _fft_axis_pallas)"),
    "dense_fft_last": (f"{CSRC}/fft_last.cu",
                       f"{DENSE}:175 (row 20, _fft_last_pallas)"),
    "dense_rfft_last": (f"{CSRC}/planar_rfft.cu",
                        f"{DENSE}:215 (row 21, rfft_last)"),
    "dense_irfft_last": (f"{CSRC}/planar_rfft.cu",
                         f"{DENSE}:266 (row 22, irfft_last)"),
    "peer_a2a": (f"{CSRC}/peer_a2a.cu", f"{RDMA}:229 (row 23, "
                                        f"rdma_all_to_all)"),
    "peer_fft_x": (f"{CSRC}/peer_fft_x.cu",
                   f"{RDMA}:437 (row 24, fused_transpose_fft_x)"),
    "peer_ifft_x": (f"{CSRC}/peer_fft_x.cu",
                    f"{RDMA}:592 (row 25, fused_ifft_x_transpose)"),
    "peer_fft_y": (f"{CSRC}/peer_fft_x.cu",
                   f"{RDMA}:733 (row 26, fused_transpose_fft_y)"),
    "peer_ifft_y": (f"{CSRC}/peer_fft_x.cu",
                    f"{RDMA}:865 (row 27, fused_ifft_y_transpose)"),
    # port-only: XLA fuses this pointwise work in the reference
    "rhs_curl": (f"{CSRC}/rhs_pointwise.cu", "none (row P1, the curl)"),
    "rhs_cross": (f"{CSRC}/rhs_pointwise.cu", "none (row P2, U x w)"),
    "rhs_leray_visc": (f"{CSRC}/rhs_pointwise.cu",
                       "none (row P3, the projection and viscous term)"),
}
# phase 12: the packed NS3D step at P = 2 under "rdma": one right-hand side
# launches row 25 twice (the state and the curl, one 3-stack each) and row
# 23 four times (the nonlinear term's transpose and the plane-0 gather, a
# launch per planar leaf); RK4 runs four a step
DIST_RHS = {"peer_a2a": 4, "peer_fft_x": 0, "peer_ifft_x": 2,
            "cross_rfft_z": 1, "fft_axis": 3, "packed_irfft_last": 2,
            "fft_x_epilogue": 1}
# phase 13: NS3D on the 2x2 pencil under "rdma", one right-hand side.
# Packed (WIDE): two packed inverses (each the x inverse, the joint
# transpose, the y inverse, the P2 transpose: two row-1 and four row-23
# launches, then the z c2r), the product with the z r2c, the P2 transpose
# with the y c2c, the joint transpose, the x epilogue, the plane-0 gather
# over the joint group (row 23 a planar leaf).  Complex: two inverses
# (rows 25, 27, 9) and the forward (rows 8, 26, 24), a 3-stack a launch,
# and the pointwise curl, product and projection, one launch each.
PENCIL_PACKED_RHS = {"peer_a2a": 14, "fft_axis": 5, "packed_irfft_last": 2,
                     "cross_rfft_z": 1, "fft_x_epilogue": 1}
PENCIL_COMPLEX_RHS = {"peer_ifft_x": 2, "peer_ifft_y": 2,
                      "planar_irfft_last": 2, "planar_rfft_last": 1,
                      "peer_fft_y": 1, "peer_fft_x": 1, "rhs_curl": 1,
                      "rhs_cross": 1, "rhs_leray_visc": 1}
NU, DT = 0.000625, 0.01
TRANSFORM_KERNELS = ("fft_axis", "packed_rfft_last", "packed_irfft_last")
PADDED_KERNELS = ("fft_axis", "planar_rfft_last", "planar_irfft_last")
PACKED_STEP_KERNELS = ("curl_ifft_x", "cross_rfft_z", "fft_x_epilogue",
                       "fft_axis", "packed_irfft_last")
# each model's packed right-hand side: its hand-written launches (RK4 runs
# four right-hand sides a step)
FAMILY_RHS = {
    "VV": {"curl_ifft_x_biot_savart": 1, "fft_axis": 2,
           "packed_irfft_last": 1, "cross_rfft_z": 1,
           "fft_x_epilogue_curl": 1},
    "MHD": {"curl_ifft_x": 2, "fft_axis": 4, "packed_irfft_last": 2,
            "cross2_rfft_z": 1, "cross_rfft_z": 1, "fft_x_epilogue": 1,
            "fft_x_epilogue_curl": 1},
    "Boussinesq": {"curl_ifft_x": 1, "fft_axis": 5, "packed_irfft_last": 2,
                   "cross_rfft_z": 1, "mul_rfft_z": 1,
                   "fft_x_epilogue_buoy": 1, "fft_x_epilogue_div": 1},
}
# the packed NS2D right-hand side's hand-written launches: the batched
# (4, N0, h) inverse (x, then z) and the forward (z, then x)
NS2D_RHS = {"packed_rfft_last_zdif": 1, "packed_irfft_last_zdif": 1,
            "fft_axis": 2}
# the same at N1 outside the DIF gate (natural lane order)
NS2D_RHS_NATURAL = {"packed_rfft_last": 1, "packed_irfft_last": 1,
                    "fft_axis": 2}
# the widened plans' timed lengths: c2c (radix 5, radix 7, 2^7·5, a direct
# 127-point stage) and the r2c with a 1021-point stage
SWEEP_TIMED_C2C = (40, 112, 640, 1016)
SWEEP_TIMED_R2C = (2042,)
WIDE = (320, 320, 1280)       # packed NS3D: radix 5 on x, y and h = 640
NU2D, DT2D = 0.001, 0.001
Z0_VORTEX_PAIR = 0.05 / (8 * np.pi)  # 0.5 <ω²> of the two Gaussians
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12      # H100 SXM FP32 outside the tensor cores
P3 = 1.5 ** 3                 # padsize³ of the 3/2 rule

failures = []


def check(ok, what):
    print(("ok   " if ok else "FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def median_ms(torch, fn, iters=30, warmup=3):
    """Median device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def rel_err(torch, got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def fft_flops(points, n, real=False):
    """FFT flops of ``points`` samples in transforms of length n."""
    return (2.5 if real else 5.0) * points * np.log2(n)


def bound(bytes_moved, flops):
    """The least time (ms) of the larger of the two bounds, and its name."""
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_f = flops / FP32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def packed_vectors(n):
    """The packed NS3D step's 1-D wavenumbers and 2/3-rule masks at n³
    (L = 2π): k0, k1, k2, m0, m1, m2 on the card."""
    from mpifft4py_tpu_torch.utils import spectral
    N = (n, n, n)
    return (spectral.factored_wavenumbers(N, None, n // 2, device="cuda")
            + spectral.packed_dealias_masks(N, "cuda"))


def kernel_phase(torch, p3, zd, dn, rng):
    """Each kernel against its twin; returns {name: its JSON numbers}."""
    def cu(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).cuda()

    errs = {k: 0.0 for k in KERNELS}

    def compare(name, label, got, ref, tol=1e-5):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            rel = rel_err(torch, g, r)
            errs[name] = max(errs[name], float((g - r).abs().max()))
            check(rel <= tol, f"kernel {name} {label}: rel err {rel:.3e} "
                              f"(max |twin| {float(r.abs().max()):.4e}, "
                              f"limit {tol:g})")

    for N in (256, 512):
        h = N // 2
        xr, xi = cu((N, N, h)), cu((N, N, h))
        for axis, stage in ((0, "x"), (1, "y")):
            for inv in (False, True):
                compare("fft_axis", f"{N}^3 {stage} stage inverse={inv}",
                        p3.fft_axis_planar(xr, xi, axis, inv),
                        p3.fft_axis_planar_ref(xr, xi, axis, inv))
        u = cu((N, N, N))
        compare("packed_rfft_last", f"{N}^3", p3.rfft_last_packed(u),
                p3.rfft_last_packed_ref(u))
        compare("packed_irfft_last", f"{N}^3",
                p3.irfft_last_packed(xr, xi, N),
                p3.irfft_last_packed_ref(xr, xi, N))
        compare("packed_rfft_last", f"fused_zy_fwd {N}^3", p3.fused_zy_fwd(u),
                p3.fused_zy_fwd_ref(u))
        compare("packed_irfft_last", f"fused_zy_bwd {N}^3",
                p3.fused_zy_bwd(xr, xi, N), p3.fused_zy_bwd_ref(xr, xi, N))
        del xr, xi, u
    xr, xi = cu((4, 384, 64)), cu((4, 384, 64))
    for inv in (False, True):
        compare("fft_axis", f"n=384 (4, 384, 64) inverse={inv}",
                p3.fft_axis_planar(xr, xi, 1, inv),
                p3.fft_axis_planar_ref(xr, xi, 1, inv))

    # fft_axis.cu's edges (rows 1 and 19): inputs and out= views 1-3 values
    # into larger buffers (row segments off the bulk copies' 16-byte grid,
    # each plane off by another amount), post = 129 (row 19's 1032-byte
    # complex64 rows, a last tile of one column), 130 and 3, pre > 1, tiles
    # one sector wide at n = 384 and 1024
    for pre, n, post, off in ((256, 256, 129, 1), (3, 1024, 130, 2),
                              (2, 384, 3, 3)):
        shape, cnt = (pre, n, post), pre * n * post

        def off_view(o, shape=shape, cnt=cnt):
            return cu((cnt + o,))[o:].view(shape)
        xr, xi = off_view(off), off_view((off + 1) % 4)
        out = (off_view((off + 2) % 4), off_view((off + 3) % 4))
        xc = torch.complex(cu((cnt + off,)),
                           cu((cnt + off,)))[off:].view(shape)
        what = f"{shape} axis 1, {off} values in"
        for inv in (False, True):
            y = p3.fft_axis_planar(xr, xi, 1, inv, out=out)
            compare("fft_axis", f"{what}, out= views, inverse={inv}", y,
                    p3.fft_axis_planar_ref(xr, xi, 1, inv))
            compare("fft_axis", f"{what} inverse={inv} round trip",
                    p3.fft_axis_planar(*y, 1, not inv), (xr, xi), 1e-6)
            y = dn.fft_axis(xc, 1, inv)
            compare("dense_fft_axis", f"{what} inverse={inv}", y,
                    dn.fft_axis_ref(xc, 1, inv))
            compare("dense_fft_axis", f"{what} inverse={inv} round trip",
                    dn.fft_axis(y, 1, not inv), xc, 1e-6)
    del out, xc, y

    # the packed NS3D step's kernels at its 256^3 shapes
    pk = (3, 256, 256, 128)
    ur, ui, sr, si = cu(pk), cu(pk), cu(pk), cu(pk)
    km = packed_vectors(256)
    for ws in (False, True):
        compare("curl_ifft_x", f"256^3 with_state={ws}",
                p3.curl_ifft_x(ur, ui, *km[:3], ws),
                p3.curl_ifft_x_ref(ur, ui, *km[:3], ws))
    compare("curl_ifft_x", "curl_irfft3d_packed 256^3 with_state",
            p3.curl_irfft3d_packed(ur, ui, *km[:3], (256,) * 3,
                                   with_state=True),
            p3.curl_irfft3d_packed_ref(ur, ui, *km[:3], (256,) * 3,
                                       with_state=True))
    a, b = cu((3, 256, 256, 256)), cu((3, 256, 256, 256))
    compare("cross_rfft_z", "256^3", p3.cross_rfft_z(a, b),
            p3.cross_rfft_z_ref(a, b))
    compare("cross_rfft_z", "cross_rfft_zy_packed 256^3",
            p3.cross_rfft_zy_packed(a, b), p3.cross_rfft_zy_packed_ref(a, b))
    a5, b5 = cu((3, 4, 512, 512)), cu((3, 4, 512, 512))
    compare("cross_rfft_z", "cross_rfft_zy_packed 512-class planes "
            "(3, 4, 512, 512), row 13's function",
            p3.cross_rfft_zy_packed(a5, b5),
            p3.cross_rfft_zy_packed_ref(a5, b5))
    del a5, b5
    epi = (lambda: p3.fft_x_epilogue_packed(ur, ui, sr, si, *km, "project",
                                            NU))
    epi_ref = (lambda: p3.fft_x_epilogue_packed_ref(ur, ui, sr, si, *km,
                                                    "project", NU))
    compare("fft_x_epilogue", "256^3 project", tuple(epi()), tuple(epi_ref()))

    # the complex layout's pointwise right-hand side (rows P1-P3): the curl
    # and the projection on the 256^3 complex step's (3, 256, 256, 129)
    # stacks with its 1-D wavenumbers, the product on the N grid's and the
    # 3/2 rule's M grid's physical stacks
    from mpifft4py_tpu_torch.utils import spectral
    kc = spectral.factored_wavenumbers((256,) * 3, None, 129, device="cuda")
    uc, fc = (torch.complex(cu((3, 256, 256, 129)), cu((3, 256, 256, 129)))
              for _ in "uf")
    compare("rhs_curl", "(3, 256, 256, 129)", p3.rhs_curl(uc, *kc),
            p3.rhs_curl_ref(uc, *kc), 1e-6)
    compare("rhs_leray_visc", "(3, 256, 256, 129)",
            p3.rhs_leray_visc(fc, uc, *kc, NU),
            p3.rhs_leray_visc_ref(fc, uc, *kc, NU), 1e-6)
    compare("rhs_cross", "(3, 256^3)", p3.rhs_cross(a, b),
            p3.rhs_cross_ref(a, b), 1e-6)
    am, bm = cu((3, 384, 384, 384)), cu((3, 384, 384, 384))
    compare("rhs_cross", "(3, 384^3), the 3/2 rule's grid",
            p3.rhs_cross(am, bm), p3.rhs_cross_ref(am, bm), 1e-6)
    del am, bm

    # the solver family's variants at the same shapes: the Biot-Savart curl
    # (VV), cross2 (MHD), mul (Boussinesq, also at 512-class planes, row
    # 13's function), the curl and div epilogues and the buoyancy rider
    for ws in (False, True):
        compare("curl_ifft_x_biot_savart", f"256^3 with_state={ws}",
                p3.curl_ifft_x(ur, ui, *km[:3], ws, True),
                p3.curl_ifft_x_ref(ur, ui, *km[:3], ws, True))
    compare("curl_ifft_x_biot_savart",
            "curl_irfft3d_packed biot_savart 256^3 with_state",
            p3.curl_irfft3d_packed(ur, ui, *km[:3], (256,) * 3,
                                   biot_savart=True, with_state=True),
            p3.curl_irfft3d_packed_ref(ur, ui, *km[:3], (256,) * 3,
                                       biot_savart=True, with_state=True))
    c3, d3 = cu((3, 256, 256, 256)), cu((3, 256, 256, 256))
    compare("cross2_rfft_z", "256^3", p3.cross_rfft_z(a, b, c3, d3),
            p3.cross_rfft_z_ref(a, b, c3, d3))
    compare("cross2_rfft_z", "cross_rfft_zy_packed cross2 256^3",
            p3.cross_rfft_zy_packed(a, b, c3, d3),
            p3.cross_rfft_zy_packed_ref(a, b, c3, d3))
    t1 = cu((1, 256, 256, 256))
    compare("mul_rfft_z", "256^3", p3.mul_rfft_z(a, t1),
            p3.mul_rfft_z_ref(a, t1))
    compare("mul_rfft_z", "mul_rfft_zy_packed 256^3",
            p3.mul_rfft_zy_packed(a, t1), p3.mul_rfft_zy_packed_ref(a, t1))
    a5, t5 = cu((3, 4, 512, 512)), cu((1, 4, 512, 512))
    compare("mul_rfft_z", "mul_rfft_zy_packed 512-class planes "
            "(3, 4, 512, 512), row 13's function",
            p3.mul_rfft_zy_packed(a5, t5), p3.mul_rfft_zy_packed_ref(a5, t5))
    del a5, t5
    s1r, s1i = cu((1, 256, 256, 128)), cu((1, 256, 256, 128))
    variants = {  # name: (state pair, mode, buoy)
        "fft_x_epilogue_curl": ((sr, si), "curl", None),
        "fft_x_epilogue_div": ((s1r, s1i), "div", None),
        "fft_x_epilogue_buoy": ((sr, si), "project", (s1r, s1i, 0.7)),
    }
    epis = {}
    for name, (st, mode, buoy) in variants.items():
        epis[name] = (
            lambda st=st, mode=mode, buoy=buoy: p3.fft_x_epilogue_packed(
                ur, ui, *st, *km, mode, NU, buoy=buoy),
            lambda st=st, mode=mode, buoy=buoy: p3.fft_x_epilogue_packed_ref(
                ur, ui, *st, *km, mode, NU, buoy=buoy))
        compare(name, f"256^3 {mode}{' + buoy' if buoy else ''}",
                tuple(epis[name][0]()), tuple(epis[name][1]()))

    # the 3/2 rule's kernels at the 256^3 padded pipeline's shapes (a
    # 3-stack on the 384^3 grid, Nf = 129), and the C2C chain's last axis
    u, u3 = cu((256, 256, 256)), cu((3, 384, 384, 384))
    compare("planar_rfft_last", "(3, 384^3) nf=129, doubled, scale 1/1.5^3",
            p3.rfft_last_planar(u3, 129, 1 / P3),
            p3.rfft_last_planar_ref(u3, 129, 1 / P3))
    compare("planar_rfft_last", "256^3 nf=None", p3.rfft_last_planar(u),
            p3.rfft_last_planar_ref(u))
    pr, pi = cu((3, 384, 384, 129)), cu((3, 384, 384, 129))
    compare("planar_irfft_last", "(3, 384, 384, 129) -> 384, nf_in=129, "
            "scale 1.5^3", p3.irfft_last_planar(pr, pi, 384, 129, P3),
            p3.irfft_last_planar_ref(pr, pi, 384, 129, P3))
    for axis, shape in ((2, (3, 384, 384, 129)), (1, (3, 384, 256, 129))):
        ar, ai = cu(shape), cu(shape)
        for inv in (False, True):
            compare("fft_axis", f"3/2-rule {shape} axis {axis} inverse={inv}",
                    p3.fft_axis_planar(ar, ai, axis, inv),
                    p3.fft_axis_planar_ref(ar, ai, axis, inv))
    del ar, ai
    # C2C at 256^3 and under the 3/2 rule on the whole 384^3 grid (384-point
    # rows: the radix-3 plan, 10 rows a block; x and y at full width), the
    # scale the 3/2 chain folds into its z stage included
    cr, ci = cu((256, 256, 256)), cu((256, 256, 256))
    for inv in (False, True):
        compare("fft_last", f"256^3 inverse={inv}",
                p3.fft_last_planar_c2c(cr, ci, inv),
                p3.fft_last_planar_c2c_ref(cr, ci, inv))
    ar, ai = cu((384, 384, 384)), cu((384, 384, 384))
    for inv, sc in ((False, 1 / P3), (True, P3)):
        compare("fft_last", f"384^3 inverse={inv} scale={sc:.6g}",
                p3.fft_last_planar_c2c(ar, ai, inv, sc),
                p3.fft_last_planar_c2c_ref(ar, ai, inv, sc))
        for axis in (0, 1):
            compare("fft_axis", f"C2C 3/2-rule 384^3 axis {axis} "
                                f"inverse={inv}",
                    p3.fft_axis_planar(ar, ai, axis, inv),
                    p3.fft_axis_planar_ref(ar, ai, axis, inv))
    del ar, ai
    # the persistent fft_last kernel's edges (rows 10 and 20): views whose
    # base is not 16-byte aligned (one row into a larger buffer at n = 129,
    # one value in at both n: every tile's head and tail then come by
    # ordinary loads), 201 rows (not a multiple of a tile's rows, and fewer
    # tiles than the persistent grid has blocks), each against its twin
    # and in a round trip through the kernel (1e-6); the dense tier at n =
    # 1021 and 2·509 (pair-sum stages above 127, compensated)
    for n in (129, 256):
        for rows, off, what in ((4096, n, "one row in"),
                                (4096, 1, "one value in"),
                                (201, 0, "201 rows"),
                                (201, 1, "201 rows, one value in")):
            br, bi = cu((rows * n + off,)), cu((rows * n + off,))
            xr, xi = br[off:].view(rows, n), bi[off:].view(rows, n)
            xc = torch.complex(br, bi)[off:].view(rows, n)
            for inv in (False, True):
                y = p3.fft_last_planar_c2c(xr, xi, inv)
                compare("fft_last", f"({rows}, {n}) {what} inverse={inv}",
                        y, p3.fft_last_planar_c2c_ref(xr, xi, inv))
                compare("fft_last", f"({rows}, {n}) {what} inverse={inv} "
                                    f"round trip",
                        p3.fft_last_planar_c2c(*y, not inv), (xr, xi), 1e-6)
                y = dn.fft_axis(xc, 1, inv)
                compare("dense_fft_last", f"({rows}, {n}) {what} "
                                          f"inverse={inv}",
                        y, dn.fft_axis_ref(xc, 1, inv))
                compare("dense_fft_last", f"({rows}, {n}) {what} "
                                          f"inverse={inv} round trip",
                        dn.fft_axis(y, 1, not inv), xc, 1e-6)
    for n in (1021, 2 * 509):
        xc = torch.complex(cu((64, n)), cu((64, n)))
        for inv in (False, True):
            y = dn.fft_axis(xc, 1, inv)
            compare("dense_fft_last", f"(64, {n}) inverse={inv}", y,
                    dn.fft_axis_ref(xc, 1, inv))
            compare("dense_fft_last", f"(64, {n}) inverse={inv} round trip",
                    dn.fft_axis(y, 1, not inv), xc, 1e-6)
    del br, bi, xr, xi, xc, y

    # the persistent r2c's edges (rows 21 and 8): inputs one value or one
    # row into a larger buffer, 201 rows and 3-stacks that are not a
    # multiple of a tile's rows (32 at n = 256, 20 at 384), the 3/2 rule's
    # truncation (nf = 129, doubled, scaled) of band-limited rows, the
    # pencil's widths 130 and 132 through out= (a pair that starts inside
    # its buffer); each against its twin and in a round trip through the c2r
    for shape, off, nf, width, out_off in (
            ((4096, 256), 1, None, None, 0), ((4096, 256), 256, None, None, 0),
            ((201, 256), 0, None, None, 0), ((3, 67, 256), 1, None, None, 0),
            ((3, 7, 384), 0, 129, None, 0), ((201, 384), 1, 129, None, 0),
            ((1000, 384), 384, None, None, 0),
            ((128, 128, 256), 0, 129, 130, 0), ((201, 256), 1, 129, 130, 1),
            ((3, 67, 256), 3, 129, 132, 2)):
        n, rows = shape[-1], int(np.prod(shape[:-1]))
        x = cu((rows * n + off,))[off:].view(shape)
        if nf is not None:
            x.copy_(p3.irfft_last_planar_ref(cu(shape[:-1] + (nf,)),
                                             cu(shape[:-1] + (nf,)), n, nf))
        sc = 1 / P3 if n == 384 else 1.0
        out = None if width is None else tuple(
            torch.zeros(rows * width + out_off, device="cuda")[out_off:]
            .view(shape[:-1] + (width,)) for _ in "ri")
        what = (f"{shape} {off} value(s) in, nf={nf}, width={width}"
                + ("" if out is None else f", out= {out_off} value(s) in"))
        y = p3.rfft_last_planar(x, nf, sc, width, out)
        compare("planar_rfft_last", what, y,
                p3.rfft_last_planar_ref(x, nf, sc, width))
        compare("planar_rfft_last", what + " round trip",
                p3.irfft_last_planar(*y, n, nf, 1 / sc), x, 1e-6)
        if nf is None:
            X = dn.rfft_last(x)
            compare("dense_rfft_last", what, X, dn.rfft_last_ref(x))
            compare("dense_rfft_last", what + " round trip",
                    dn.irfft_last(X, n), x, 1e-6)
    del x, y, X, out

    # rows 4 and 17 on the same persistent r2c: inputs 1-3 values into a
    # larger buffer (bulk-copy heads and tails off the 16-byte grid), stacks
    # that end in a partial tile (32 rows a tile at n = 256, 16 at 512, 10
    # at 768, 8 at 1024, 4 at 2042), the DIF order; each against its twin
    # and in a round trip through the packed c2r; then spectra 1-3 values
    # into their buffers through the launchers (the wrappers allocate
    # aligned ones) and a base off the 4-byte grid, refused
    for shape, off, dif in (((4096, 256), 1, False), ((201, 256), 2, False),
                            ((3, 67, 256), 3, False), ((33, 2042), 1, False),
                            ((7, 16), 3, False), ((201, 512), 1, True),
                            ((3, 25, 768), 2, True), ((1000, 1024), 3, True),
                            ((9, 1024), 0, True)):
        n = shape[-1]
        x = cu((int(np.prod(shape)) + off,))[off:].view(shape)
        name = "packed_rfft_last" + ("_zdif" if dif else "")
        fwd = zd.rfft_last_zdif if dif else p3.rfft_last_packed
        twin = zd.rfft_last_zdif_ref if dif else p3.rfft_last_packed_ref
        what = f"{shape} {off} value(s) in"
        y = fwd(x)
        compare(name, what, y, twin(x))
        compare(name, what + " round trip",
                p3.irfft_last_packed(*y, n, dif=dif), x, 1e-6)
    from mpifft4py_tpu_torch.ops import _build
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    for rows, n, off, dif in ((77, 256, 1, False), (77, 1024, 2, False),
                              (9, 2042, 3, False), (77, 1024, 2, True),
                              (25, 768, 3, True)):
        h = n // 2
        x = cu((rows * n + off,))[off:].view(rows, n)
        yr, yi = (torch.zeros(rows * h + off, device="cuda")[off:]
                  .view(rows, h) for _ in "ri")
        fn = lib.packed_rfft_zdif_launch if dif else lib.packed_rfft_launch
        tws = (p3._twiddles(h, h, -1, x.device).data_ptr(),
               p3._twiddles(n, h, -1, x.device).data_ptr())
        rc = fn(x.data_ptr(), yr.data_ptr(), yi.data_ptr(), *tws, rows, n,
                stream)
        check(rc == 0, f"kernel packed r2c launcher ({rows}, {n}) dif={dif}, "
                       f"spectrum {off} value(s) in: rc {rc}")
        compare("packed_rfft_last" + ("_zdif" if dif else ""),
                f"launcher ({rows}, {n}), spectrum {off} value(s) in",
                (yr, yi), (zd.rfft_last_zdif_ref if dif
                           else p3.rfft_last_packed_ref)(x))
        rc = fn(x.data_ptr() + 2, yr.data_ptr(), yi.data_ptr(), *tws, rows, n,
                stream)
        check(rc != 0, f"kernel packed r2c launcher ({rows}, {n}) dif={dif} "
                       f"refuses a base off the 4-byte grid: rc {rc}")
    del x, y, yr, yi

    # rows 17-18, the DIF lane order of the packed 2D layout, at 1e-6: the
    # whole 1024^2 field (1024 rows of n) and the (4, 1024, n/2) stack of
    # NS2D's batched inverse, row 17 also against row 4 permuted, and a
    # round trip
    for n in (512, 768, 1024):
        f = cu((1024, n))
        zr, zi = zd.rfft_last_zdif(f)
        compare("packed_rfft_last_zdif", f"(1024, {n})", (zr, zi),
                zd.rfft_last_zdif_ref(f), 1e-6)
        perm = torch.from_numpy(zd.zdif_perm(n)).cuda()
        nr, ni = p3.rfft_last_packed(f)
        compare("packed_rfft_last_zdif", f"(1024, {n}) vs row 4 permuted",
                (zr, zi), (nr[:, perm], ni[:, perm]), 1e-6)
        compare("packed_irfft_last_zdif", f"round trip (1024, {n})",
                zd.irfft_last_zdif(zr, zi, n), f, 1e-6)
        sr4, si4 = cu((4, 1024, n // 2)), cu((4, 1024, n // 2))
        compare("packed_irfft_last_zdif", f"(4, 1024, {n // 2}) -> {n}",
                zd.irfft_last_zdif(sr4, si4, n),
                zd.irfft_last_zdif_ref(sr4, si4, n), 1e-6)
    # the n = 1024 field and stack are NS2D 1024^2's shapes: timed below
    f2 = f
    s4c = torch.complex(cu((4, 1024, 513)), cu((4, 1024, 513)))

    # rows 19-22, the dense tier, at the shapes of the 256^3 chain (the
    # composition of benchmarks/pallas_tuning.py): the r2c of (256, 256,
    # 256), c2c along axes 0, 1 and 2 of the (256, 256, 129) spectrum
    # (129 = 3·43: a direct 43-point stage), the c2r back; then the
    # full-length r2c/c2r at odd n
    ud = cu((256, 256, 256))
    Xd = torch.complex(cu((256, 256, 129)), cu((256, 256, 129)))
    compare("dense_rfft_last", "(256, 256, 256)", dn.rfft_last(ud),
            dn.rfft_last_ref(ud))
    compare("dense_irfft_last", "(256, 256, 129) -> 256",
            dn.irfft_last(Xd, 256), dn.irfft_last_ref(Xd, 256))
    for axis, name in ((0, "dense_fft_axis"), (1, "dense_fft_axis"),
                       (2, "dense_fft_last")):
        for inv in (False, True):
            compare(name, f"(256, 256, 129) axis {axis} inverse={inv}",
                    dn.fft_axis(Xd, axis, inv), dn.fft_axis_ref(Xd, axis, inv))
    for n in (15, 41, 127, 1023):
        x = cu((64, n))
        X = dn.rfft_last(x)
        compare("dense_rfft_last", f"odd n={n} (64, {n})", X,
                dn.rfft_last_ref(x))
        compare("dense_irfft_last", f"odd n={n} round trip",
                dn.irfft_last(X, n), x, 1e-6)
        Y = torch.complex(cu((64, n // 2 + 1)), cu((64, n // 2 + 1)))
        compare("dense_irfft_last", f"odd n={n} (64, {n // 2 + 1})",
                dn.irfft_last(Y, n), dn.irfft_last_ref(Y, n))

    # times at the main path's shapes: kernel, twin and the one torch.fft
    # call computing the same function (None for the fused kernels), in
    # turns, with the bound of the call's bytes and flops
    xr, xi = cu((256, 256, 128)), cu((256, 256, 128))
    z, zc = torch.complex(xr, xi), torch.complex(cr, ci)
    zh = torch.complex(cu((256, 256, 129)), cu((256, 256, 129)))
    ph = torch.complex(pr, pi)
    ar, ai = cu((384, 384, 384)), cu((384, 384, 384))
    a384 = torch.complex(ar, ai)
    n3, pk3 = 256 ** 3, 3 * 256 * 256 * 128
    cases = {
        "curl_ifft_x": (lambda: p3.curl_ifft_x(ur, ui, *km[:3], True),
                        lambda: p3.curl_ifft_x_ref(ur, ui, *km[:3], True),
                        None, 3 * nbytes(ur, ui),
                        fft_flops(2 * pk3, 256)),
        "cross_rfft_z": (lambda: p3.cross_rfft_z(a, b),
                         lambda: p3.cross_rfft_z_ref(a, b), None,
                         nbytes(a, b, ur, ui), fft_flops(3 * n3, 256, True)),
        "fft_x_epilogue": (epi, epi_ref, None, 6 * nbytes(ur),
                           fft_flops(pk3, 256)),
        # rows P1-P3: one read of each input, one write (48, 36 and 72
        # bytes a point), no FFT
        "rhs_curl": (lambda: p3.rhs_curl(uc, *kc),
                     lambda: p3.rhs_curl_ref(uc, *kc), None, 2 * nbytes(uc),
                     0),
        "rhs_cross": (lambda: p3.rhs_cross(a, b),
                      lambda: p3.rhs_cross_ref(a, b), None, 3 * nbytes(a), 0),
        "rhs_leray_visc": (lambda: p3.rhs_leray_visc(fc, uc, *kc, NU),
                           lambda: p3.rhs_leray_visc_ref(fc, uc, *kc, NU),
                           None, 3 * nbytes(uc), 0),
        "curl_ifft_x_biot_savart": (
            lambda: p3.curl_ifft_x(ur, ui, *km[:3], True, True),
            lambda: p3.curl_ifft_x_ref(ur, ui, *km[:3], True, True), None,
            3 * nbytes(ur, ui), fft_flops(2 * pk3, 256)),
        "cross2_rfft_z": (lambda: p3.cross_rfft_z(a, b, c3, d3),
                          lambda: p3.cross_rfft_z_ref(a, b, c3, d3), None,
                          nbytes(a, b, c3, d3, ur, ui),
                          fft_flops(3 * n3, 256, True)),
        "mul_rfft_z": (lambda: p3.mul_rfft_z(a, t1),
                       lambda: p3.mul_rfft_z_ref(a, t1), None,
                       nbytes(a, t1, ur, ui), fft_flops(3 * n3, 256, True)),
        "fft_x_epilogue_curl": (*epis["fft_x_epilogue_curl"], None,
                                6 * nbytes(ur), fft_flops(pk3, 256)),
        "fft_x_epilogue_div": (*epis["fft_x_epilogue_div"], None,
                               2 * nbytes(ur) + 4 * nbytes(s1r),
                               fft_flops(pk3, 256)),
        "fft_x_epilogue_buoy": (*epis["fft_x_epilogue_buoy"], None,
                                6 * nbytes(ur) + 2 * nbytes(s1r),
                                fft_flops(pk3, 256)),
        "fft_axis": (lambda: p3.fft_axis_planar(xr, xi, 0),
                     lambda: p3.fft_axis_planar_ref(xr, xi, 0),
                     lambda: torch.fft.fft(z, dim=0), 4 * nbytes(xr),
                     fft_flops(xr.numel(), 256)),
        "packed_rfft_last": (lambda: p3.rfft_last_packed(u),
                             lambda: p3.rfft_last_packed_ref(u),
                             lambda: torch.fft.rfft(u, dim=-1),
                             2 * nbytes(u), fft_flops(n3, 256, True)),
        "packed_irfft_last": (lambda: p3.irfft_last_packed(xr, xi, 256),
                              lambda: p3.irfft_last_packed_ref(xr, xi, 256),
                              lambda: torch.fft.irfft(zh, n=256, dim=-1),
                              2 * nbytes(u), fft_flops(n3, 256, True)),
        "planar_rfft_last": (lambda: p3.rfft_last_planar(u3, 129, 1 / P3),
                             lambda: p3.rfft_last_planar_ref(u3, 129, 1 / P3),
                             lambda: torch.fft.rfft(u3, dim=-1),
                             nbytes(u3, pr, pi),
                             fft_flops(u3.numel(), 384, True)),
        "planar_irfft_last": (
            lambda: p3.irfft_last_planar(pr, pi, 384, 129, P3),
            lambda: p3.irfft_last_planar_ref(pr, pi, 384, 129, P3),
            lambda: torch.fft.irfft(ph, n=384, dim=-1), nbytes(u3, pr, pi),
            fft_flops(u3.numel(), 384, True)),
        "fft_last": (lambda: p3.fft_last_planar_c2c(cr, ci),
                     lambda: p3.fft_last_planar_c2c_ref(cr, ci),
                     lambda: torch.fft.fft(zc, dim=-1), 4 * nbytes(cr),
                     fft_flops(cr.numel(), 256)),
        # the 3/2-rule C2C's z stage: 384-point rows with the scale
        "fft_last_384": (lambda: p3.fft_last_planar_c2c(ar, ai, False, 1 / P3),
                         lambda: p3.fft_last_planar_c2c_ref(ar, ai, False,
                                                            1 / P3),
                         lambda: torch.fft.fft(a384, dim=-1), 4 * nbytes(ar),
                         fft_flops(ar.numel(), 384)),
        # NS2D 1024^2: the forward on the field, the inverse on the stack
        "packed_rfft_last_zdif": (
            lambda: zd.rfft_last_zdif(f2), lambda: zd.rfft_last_zdif_ref(f2),
            lambda: torch.fft.rfft(f2, dim=-1), 2 * nbytes(f2),
            fft_flops(f2.numel(), 1024, True)),
        "packed_irfft_last_zdif": (
            lambda: zd.irfft_last_zdif(sr4, si4, 1024),
            lambda: zd.irfft_last_zdif_ref(sr4, si4, 1024),
            lambda: torch.fft.irfft(s4c, n=1024, dim=-1),
            2 * nbytes(sr4, si4), fft_flops(2 * sr4.numel(), 1024, True)),
        # the dense 256^3 chain: y on the spectrum (x alike), the last axis
        # of the spectrum, the r2c and the c2r
        "dense_fft_axis": (lambda: dn.fft_axis(Xd, 1),
                           lambda: dn.fft_axis_ref(Xd, 1),
                           lambda: torch.fft.fft(Xd, dim=1), 2 * nbytes(Xd),
                           fft_flops(Xd.numel(), 256)),
        "dense_fft_last": (lambda: dn.fft_axis(Xd, 2),
                           lambda: dn.fft_axis_ref(Xd, 2),
                           lambda: torch.fft.fft(Xd, dim=2), 2 * nbytes(Xd),
                           fft_flops(Xd.numel(), 129)),
        "dense_rfft_last": (lambda: dn.rfft_last(ud),
                            lambda: dn.rfft_last_ref(ud),
                            lambda: torch.fft.rfft(ud, dim=-1),
                            nbytes(ud, Xd), fft_flops(ud.numel(), 256, True)),
        "dense_irfft_last": (lambda: dn.irfft_last(Xd, 256),
                             lambda: dn.irfft_last_ref(Xd, 256),
                             lambda: torch.fft.irfft(Xd, n=256, dim=-1),
                             nbytes(ud, Xd),
                             fft_flops(ud.numel(), 256, True)),
    }
    out = {}
    for name, (kern, plain, lib, nb, fl) in cases.items():
        p1, k1 = median_ms(torch, plain), median_ms(torch, kern)
        l1 = median_ms(torch, lib) if lib else None
        k2, p2 = median_ms(torch, kern), median_ms(torch, plain)
        b_ms, b_by = bound(nb, fl)
        out[name] = dict(max_abs_err=errs[name], ms=min(k1, k2),
                         plain_ms=min(p1, p2), bound_ms=b_ms, bound_by=b_by,
                         library_ms=l1)
        print(f"time {name}: kernel {k1:.4f} / {k2:.4f} ms, plain twin "
              f"{p1:.4f} / {p2:.4f} ms, torch.fft "
              f"{'none' if l1 is None else f'{l1:.4f} ms'}, bound "
              f"{b_ms:.4f} ms ({b_by}: {nb / 1e6:.1f} MB, "
              f"{fl / 1e9:.2f} GFLOP)", flush=True)
    # rows 2-3 (the fused z+y, served by two launches each) beside the one
    # torch.fft call that computes the same function, 256^3
    u = cu((256, 256, 256))
    yr, yi = p3.fused_zy_fwd(u)
    yc = torch.fft.rfft2(u, dim=(-2, -1))
    for label, kern, lib in (
            ("fused_zy_fwd (rows 4 + 1)", lambda: p3.fused_zy_fwd(u),
             lambda: torch.fft.rfft2(u, dim=(-2, -1))),
            ("fused_zy_bwd (rows 1 + 5)", lambda: p3.fused_zy_bwd(yr, yi, 256),
             lambda: torch.fft.irfft2(yc, s=(256, 256), dim=(-2, -1)))):
        k1, l1 = median_ms(torch, kern), median_ms(torch, lib)
        l2, k2 = median_ms(torch, lib), median_ms(torch, kern)
        print(f"time {label} 256^3: two launches {k1:.4f} / {k2:.4f} ms, "
              f"torch.fft {'rfft2' if 'fwd' in label else 'irfft2'} over "
              f"the last two axes {l1:.4f} / {l2:.4f} ms", flush=True)
    del u, yr, yi, yc
    # row 16 (the pencil's WIDE nonlinear leg: rows 12/15's z kernel on one
    # rank's (3, 128, 128, 256) of the 2x2 pencil at 256^3), no torch.fft
    # call computes it
    aw, bw = cu((3, 128, 128, 256)), cu((3, 128, 128, 256))
    yw = p3.cross_rfft_z(aw, bw)
    compare("cross_rfft_z", "row 16 (3, 128, 128, 256)", yw,
            p3.cross_rfft_z_ref(aw, bw))
    b_ms, b_by = bound(nbytes(aw, bw, *yw),
                       fft_flops(aw.numel(), 256, True))
    k1, p1 = (median_ms(torch, lambda: p3.cross_rfft_z(aw, bw)),
              median_ms(torch, lambda: p3.cross_rfft_z_ref(aw, bw)))
    p2, k2 = (median_ms(torch, lambda: p3.cross_rfft_z_ref(aw, bw)),
              median_ms(torch, lambda: p3.cross_rfft_z(aw, bw)))
    print(f"time row 16 cross_rfft_z (3, 128, 128, 256), a rank of the WIDE "
          f"leg: kernel {k1:.4f} / {k2:.4f} ms, plain twin {p1:.4f} / "
          f"{p2:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
          f"{nbytes(aw, bw, *yw) / 1e6:.1f} MB)", flush=True)
    del aw, bw, yw
    return out


def peer_kernel_phase(torch, rdma, rng):
    """Rows 23-27 against their plain twins with in-process buffer tables
    (P ranks emulated: one launch a rank) at P = 2 and 4 and the 256³
    shapes of phases 12 and 13 (relative 1e-5; rows 26-27 on the 2x2 and
    the 1x4 pencil's z pairs), the P = 2 call of rank 0 timed beside its
    twin and the same work in torch; returns their JSON numbers."""
    def cu(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).cuda()

    errs = dict.fromkeys(("peer_a2a", "peer_fft_x", "peer_ifft_x",
                          "peer_fft_y", "peer_ifft_y"), 0.0)

    def compare(name, label, got, ref):
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            rel = rel_err(torch, g, r)
            errs[name] = max(errs[name], float((g - r).abs().max()))
            check(rel <= 1e-5, f"kernel {name} {label}: rel err {rel:.3e} "
                               f"(limit 1e-5)")

    n, C, h = 256, 3, 128
    for P in (2, 4):
        np0, np1 = n // P, n // P
        # row 23 at the nonlinear term's transpose: (3, Np0, N1, h) split 2
        # -> concat 1, distinct values in every rank's input
        xs = [cu((C, np0, n, h)) + 1e3 * r for r in range(P)]
        out = (1, C, n, np1, h)
        kb = rdma.SymmetricBuffer.local(P, out, "cuda")
        pb = rdma.SymmetricBuffer.local(P, out, "cuda")
        for my in range(P):
            rdma.a2a_push(xs[my], kb, my, 2, 1)
            rdma.a2a_push_ref(xs[my], pb, my, 2, 1)
        compare("peer_a2a", f"P={P} (3, {np0}, 256, 128) 2->1",
                kb.tensors, pb.tensors)
        # rows 24-25 at the slab transform's pair (1, Np0, N1, h)
        pull = rdma.SymmetricBuffer([cu((2, 1, np0, n, h)) + r
                                     for r in range(P)])
        for my in range(P):
            compare("peer_fft_x", f"P={P} rank {my} (2, 1, {np0}, 256, 128)",
                    tuple(rdma.fft_x_pull(pull, my)),
                    tuple(rdma.fft_x_pull_ref(pull, my)))
        kb = rdma.SymmetricBuffer.local(P, (2, 1, np0, n, h), "cuda")
        pb = rdma.SymmetricBuffer.local(P, (2, 1, np0, n, h), "cuda")
        spec = [(cu((1, n, np1, h)), cu((1, n, np1, h))) for _ in range(P)]
        for my, (xr, xi) in enumerate(spec):
            rdma.ifft_x_push(xr, xi, kb, my)
            rdma.ifft_x_push_ref(xr, xi, pb, my)
        compare("peer_ifft_x", f"P={P} (1, 256, {np1}, 128)", kb.tensors,
                pb.tensors)
        del xs, kb, pb, pull, spec
        # rows 26-27 at the pencil's z pair: 2x2 (1, 128, 128, 130) ->
        # (1, 128, 256, 65); 1x4 (1, 256, 64, 132) -> (1, 256, 256, 33)
        n0, W = n // (4 // P), (n // 2 + 1 + P - 1) // P * P
        n1loc, w2 = n // P, W // P
        pull = rdma.SymmetricBuffer([cu((2, 1, n0, n1loc, W)) + r
                                     for r in range(P)])
        for my in range(P):
            compare("peer_fft_y", f"P2={P} rank {my} (2, 1, {n0}, {n1loc}, "
                                  f"{W})",
                    tuple(rdma.fft_y_pull(pull, my)),
                    tuple(rdma.fft_y_pull_ref(pull, my)))
        kb = rdma.SymmetricBuffer.local(P, (2, 1, n0, n1loc, W), "cuda")
        pb = rdma.SymmetricBuffer.local(P, (2, 1, n0, n1loc, W), "cuda")
        spec = [(cu((1, n0, n, w2)), cu((1, n0, n, w2))) for _ in range(P)]
        for my, (xr, xi) in enumerate(spec):
            rdma.ifft_y_push(xr, xi, kb, my)
            rdma.ifft_y_push_ref(xr, xi, pb, my)
        compare("peer_ifft_y", f"P2={P} (1, {n0}, 256, {w2})", kb.tensors,
                pb.tensors)
        del kb, pb, pull, spec

    # the timed cases: rank 0 of P = 2
    P, np0, np1 = 2, n // 2, n // 2
    xs = [cu((C, np0, n, h)) for _ in range(P)]
    a2a_buf = rdma.SymmetricBuffer.local(P, (1, C, n, np1, h), "cuda")
    pull = rdma.SymmetricBuffer([cu((2, 1, np0, n, h)) for _ in range(P)])
    zb = [torch.complex(t[0, 0, :, :np1], t[1, 0, :, :np1]).contiguous()
          for t in pull.tensors]          # the blocks rank 0 receives
    xr, xi = cu((1, n, np1, h)), cu((1, n, np1, h))
    z = torch.complex(xr[0], xi[0])
    push = rdma.SymmetricBuffer.local(P, (2, 1, np0, n, h), "cuda")
    dst = [torch.empty((np0, np1, h), dtype=torch.complex64, device="cuda")
           for _ in range(P)]

    def ifft_lib():
        y = torch.fft.ifft(z, dim=0)
        for d in range(P):
            dst[d].copy_(y[d * np0:(d + 1) * np0])

    # rows 26-27, rank 0 of the 2x2 pencil's P2 = 2 group at 256^3: the z
    # pair (1, 128, 128, 130) of each rank, w2 = 65 lanes
    n0y, W, n1loc, w2 = n // 2, 130, n // 2, 65
    ypull = rdma.SymmetricBuffer([cu((2, 1, n0y, n1loc, W))
                                  for _ in range(P)])
    yb = [torch.complex(t[0, 0, :, :, :w2], t[1, 0, :, :, :w2]).contiguous()
          for t in ypull.tensors]         # the lane blocks rank 0 receives
    yxr, yxi = cu((1, n0y, n, w2)), cu((1, n0y, n, w2))
    yz = torch.complex(yxr[0], yxi[0])
    ypush = rdma.SymmetricBuffer.local(P, (2, 1, n0y, n1loc, W), "cuda")
    ydst = [torch.empty((n0y, n1loc, w2), dtype=torch.complex64,
                        device="cuda") for _ in range(P)]

    def ifft_y_lib():
        y = torch.fft.ifft(yz, dim=1)
        for d in range(P):
            ydst[d].copy_(y[:, d * n1loc:(d + 1) * n1loc])

    ypair = 2 * 4 * n0y * n * w2        # one rank's received pair, bytes
    pair = 2 * 4 * np0 * n * h          # one rank's planar pair, bytes
    cases = {
        "peer_a2a": (lambda: rdma.a2a_push(xs[0], a2a_buf, 0, 2, 1),
                     lambda: rdma.a2a_push_ref(xs[0], a2a_buf, 0, 2, 1),
                     None, 2 * nbytes(xs[0]), 0.0),
        "peer_fft_x": (lambda: rdma.fft_x_pull(pull, 0),
                       lambda: rdma.fft_x_pull_ref(pull, 0),
                       lambda: torch.fft.fft(torch.cat(zb), dim=0),
                       2 * pair, fft_flops(n * np1 * h, n)),
        "peer_ifft_x": (lambda: rdma.ifft_x_push(xr, xi, push, 0),
                        lambda: rdma.ifft_x_push_ref(xr, xi, push, 0),
                        ifft_lib, 2 * pair, fft_flops(n * np1 * h, n)),
        "peer_fft_y": (lambda: rdma.fft_y_pull(ypull, 0),
                       lambda: rdma.fft_y_pull_ref(ypull, 0),
                       lambda: torch.fft.fft(torch.cat(yb, dim=1), dim=1),
                       2 * ypair, fft_flops(n0y * n * w2, n)),
        "peer_ifft_y": (lambda: rdma.ifft_y_push(yxr, yxi, ypush, 0),
                        lambda: rdma.ifft_y_push_ref(yxr, yxi, ypush, 0),
                        ifft_y_lib, 2 * ypair, fft_flops(n0y * n * w2, n)),
    }
    res = {}
    for name, (kern, plain, lib, nb, fl) in cases.items():
        p1, k1 = median_ms(torch, plain), median_ms(torch, kern)
        l1 = median_ms(torch, lib) if lib else None
        k2, p2 = median_ms(torch, kern), median_ms(torch, plain)
        b_ms, b_by = bound(nb, fl)
        res[name] = dict(max_abs_err=errs[name], ms=min(k1, k2),
                         plain_ms=min(p1, p2), bound_ms=b_ms, bound_by=b_by,
                         library_ms=l1)
        print(f"time {name} (P=2, rank 0's call): kernel {k1:.4f} / "
              f"{k2:.4f} ms, plain twin {p1:.4f} / {p2:.4f} ms, torch "
              f"{'none' if l1 is None else f'{l1:.4f} ms'}, bound "
              f"{b_ms:.4f} ms ({b_by}: {nb / 1e6:.1f} MB)", flush=True)
    return res


def envelope_phase(torch, p3, dn):
    """The widened plans against their twins: ``fft_axis`` and
    ``fft_last`` at every ``supported_c2c`` n in 8..1024; at every even n
    in 16..2048 the packed r2c/c2r, the planar r2c (rows 8 and 21's
    kernel) into nf = n/2 + 1 columns of a wider row and truncated to about
    n/3 + 1 (doubled, scaled), and the dense r2c (row 21); each forward
    against its twin (1e-5 relative, as every kernel) and, where the
    spectrum is whole, in a round trip through the kernels (1e-6
    relative); the worst of each printed; then times at the lengths of
    SWEEP_TIMED_* (radix 5, radix 7, a 127-point stage; at n = 2042 a
    1021-point pair-sum one in the packed, planar and dense r2c, one
    kernel) beside the powers of two next to them."""
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def cu(shape):
        return torch.randn(shape, generator=g, device="cuda")

    worst = {}

    def note(key, got, ref, tol, what):
        errs = [rel_err(torch, a, b) for a, b in zip(got, ref)]
        worst[key] = max(worst.get(key, (0.0, 0))[0], max(errs)), \
            worst.get(key, (0.0, 0))[1] + 1
        if max(errs) > tol:
            check(False, f"sweep {what}: rel err {max(errs):.3e} (limit "
                         f"{tol:g})")

    for n in range(8, 1025):
        if not p3.supported_c2c(n):
            continue
        for name, shape, axis in (("fft_axis", (2, n, 16), 1),
                                  ("fft_last", (16, n), 1)):
            xr, xi = cu(shape), cu(shape)
            fn = (p3.fft_axis_planar if name == "fft_axis" else
                  lambda a, b, ax, inv: p3.fft_last_planar_c2c(a, b, inv))
            twin = (p3.fft_axis_planar_ref if name == "fft_axis" else
                    lambda a, b, ax, inv: p3.fft_last_planar_c2c_ref(a, b,
                                                                     inv))
            y = fn(xr, xi, axis, False)
            note(f"{name} vs twin", y, twin(xr, xi, axis, False), 1e-5,
                 f"{name} n={n}")
            note(f"{name} round trip", fn(*y, axis, True), (xr, xi), 1e-6,
                 f"{name} n={n} round trip")
    for n in range(16, 2049, 2):
        x = cu((8, n))
        y = p3.rfft_last_packed(x)
        ref = p3.rfft_last_packed_ref(x)
        note("packed_rfft_last vs twin", y, ref, 1e-5, f"rfft n={n}")
        note("packed_irfft_last vs twin", (p3.irfft_last_packed(*ref, n),),
             (p3.irfft_last_packed_ref(*ref, n),), 1e-5, f"irfft n={n}")
        note("packed r2c/c2r round trip", (p3.irfft_last_packed(*y, n),),
             (x,), 1e-6, f"packed n={n} round trip")
        # rows 8 and 21: the full spectrum into a wider row, a 3/2-rule-like
        # truncation (doubled, scaled), numpy's rfft as complex64
        h = n // 2
        for nf, width, sc in ((h + 1, h + 4, 1.0), (n // 3 + 1, n // 3 + 2,
                                                    1 / P3)):
            key = "planar_rfft_last" + (" vs twin" if nf == h + 1 else
                                        " truncated vs twin")
            y = p3.rfft_last_planar(x, nf, sc, width)
            note(key, y, p3.rfft_last_planar_ref(x, nf, sc, width), 1e-5,
                 f"planar rfft n={n} nf={nf} width={width}")
            if nf == h + 1:
                note("planar r2c/c2r round trip",
                     (p3.irfft_last_planar(*y, n, None, 1 / sc),), (x,),
                     1e-6, f"planar n={n} round trip")
        X = dn.rfft_last(x)
        note("dense_rfft_last vs twin", (X,), (dn.rfft_last_ref(x),), 1e-5,
             f"dense rfft n={n}")
        note("dense r2c/c2r round trip", (dn.irfft_last(X, n),), (x,), 1e-6,
             f"dense n={n} round trip")
    for key, (err, count) in worst.items():
        print(f"sweep {key}: worst rel err {err:.3e} over {count} lengths",
              flush=True)
    check(len(worst) == 12 and all(c > 500 for _, c in worst.values()),
          f"sweep covered {sum(c for _, c in worst.values())} (kernel, "
          f"length) pairs")

    for n in sorted(set(SWEEP_TIMED_C2C) | {1024}):
        xr, xi = cu((n, 32768)), cu((n, 32768))
        z = torch.complex(xr, xi)
        nb, fl = 4 * nbytes(xr), fft_flops(xr.numel(), n)
        b_ms, b_by = bound(nb, fl)
        for name, kern, lib in (
                ("fft_axis", lambda: p3.fft_axis_planar(xr, xi, 0),
                 lambda: torch.fft.fft(z, dim=0)),
                ("fft_last", lambda: p3.fft_last_planar_c2c(
                    xr.view(32768, n), xi.view(32768, n)),
                 lambda: torch.fft.fft(z.view(32768, n), dim=1))):
            k1, l1 = median_ms(torch, kern, 10), median_ms(torch, lib, 10)
            k2 = median_ms(torch, kern, 10)
            print(f"time sweep {name} n={n} ({n} x 32768 points): kernel "
                  f"{k1:.4f} / {k2:.4f} ms, torch.fft {l1:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)
        del xr, xi, z
    for n in sorted(set(SWEEP_TIMED_R2C) | {2048}):
        x = cu((16384, n))
        yr, yi = p3.rfft_last_packed(x)
        z = torch.fft.rfft(x, dim=-1)
        spec = 16384 * (n // 2 + 1) * 8    # a planar or complex64 spectrum
        for name, kern, lib, nb in (
                ("packed_rfft_last", lambda: p3.rfft_last_packed(x),
                 lambda: torch.fft.rfft(x, dim=-1), 2 * nbytes(x)),
                ("packed_irfft_last", lambda: p3.irfft_last_packed(yr, yi, n),
                 lambda: torch.fft.irfft(z, n=n, dim=-1), 2 * nbytes(x)),
                ("planar_rfft_last", lambda: p3.rfft_last_planar(x),
                 lambda: torch.fft.rfft(x, dim=-1), nbytes(x) + spec),
                ("dense_rfft_last", lambda: dn.rfft_last(x),
                 lambda: torch.fft.rfft(x, dim=-1), nbytes(x) + spec)):
            b_ms, b_by = bound(nb, fft_flops(x.numel(), n, True))
            k1, l1 = median_ms(torch, kern, 10), median_ms(torch, lib, 10)
            k2 = median_ms(torch, kern, 10)
            print(f"time sweep {name} n={n} (16384 rows): kernel {k1:.4f} / "
                  f"{k2:.4f} ms, torch.fft {l1:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by})", flush=True)
        del x, yr, yi, z


def transform_phase(torch, p3, R2C, rng):
    for N in (256, 512):
        shape = (N, N, N)
        FFT = R2C(np.array(shape), np.array([TAU] * 3), None, "single",
                  device="cuda")
        u = FFT.shard_real(rng.standard_normal(shape).astype(np.float32))
        before = dict(p3.LAUNCHES)
        ref = torch.fft.rfftn(u.double())
        fu = FFT.fftn(u)
        check(rel_err(torch, fu, ref) <= 1e-5,
              f"R2C {N}^3 fftn vs float64 rfftn: rel err "
              f"{rel_err(torch, fu, ref):.3e}")
        back = FFT.ifftn(fu)
        check(rel_err(torch, back, u) < 1e-6,
              f"R2C {N}^3 ifftn(fftn(u)) round trip: rel err "
              f"{rel_err(torch, back, u):.3e}")
        fu23 = FFT.fftn(u, dealias="2/3-rule")
        ref23 = ref * FFT.get_dealias_filter()
        err23 = float((fu23 - ref23).abs().max() / ref.abs().max())
        check(err23 <= 1e-5, f"R2C {N}^3 2/3-rule forward vs masked float64 "
                             f"spectrum: rel err {err23:.3e}")
        del ref, fu, back, fu23, ref23
        for k in TRANSFORM_KERNELS:
            check(p3.LAUNCHES[k] > before[k],
                  f"R2C {N}^3 launched {k}: {p3.LAUNCHES[k] - before[k]}")
        fwd, bwd = FFT.forward_fn(), FFT.backward_fn()
        t_k1 = median_ms(torch, lambda: bwd(fwd(u)))
        t_t1 = median_ms(torch, lambda: torch.fft.irfftn(
            torch.fft.rfftn(u), s=shape))
        t_t2 = median_ms(torch, lambda: torch.fft.irfftn(
            torch.fft.rfftn(u), s=shape))
        t_k2 = median_ms(torch, lambda: bwd(fwd(u)))
        print(f"time R2C {N}^3 round trip backward_fn()(forward_fn()(u)): "
              f"{t_k1:.4f} / {t_k2:.4f} ms; torch.fft irfftn(rfftn(u)) "
              f"float32: {t_t1:.4f} / {t_t2:.4f} ms", flush=True)
        del u, FFT


def fold_full_axes(torch, c, N, axes):
    """Truncate full (fft-layout) axes of a spectrum from M to N, summing
    the split Nyquist (the exact aliasing of modes ±N/2)."""
    h = N // 2
    for ax in axes:
        m = c.shape[ax]
        c = torch.cat([c.narrow(ax, 0, h),
                       c.narrow(ax, h, 1) + c.narrow(ax, m - h, 1),
                       c.narrow(ax, m - h + 1, h - 1)], dim=ax)
    return c


def alias_oracle(torch, w_M, N, padsize):
    """The exact N-grid spectrum of the M-grid field w_M, in float64: the
    full axes fold their split Nyquist, the z-Nyquist plane is the alias
    sum c + conj(c(−k0, −k1)) (tests/test_nyquist_alias.py's oracle)."""
    c = fold_full_axes(torch, torch.fft.rfftn(w_M.double()) / padsize ** 3,
                       N, (0, 1))
    h = N // 2
    q = c[..., h]
    q = q + torch.roll(torch.flip(q, (0, 1)), (1, 1), (0, 1)).conj()
    return torch.cat([c[..., :h], q[..., None]], dim=-1)


def padded_transform_phase(torch, p3, R2C, C2C, rng):
    """The 3/2 rule and slab.C2C at 256^3: accuracy, launches, round-trip
    times beside torch.fft's."""
    N = 256
    shape = (N, N, N)
    L = np.array([TAU] * 3)
    FFT = R2C(np.array(shape), L, None, "single", device="cuda")
    before = dict(p3.LAUNCHES)
    fu = FFT.fftn(FFT.shard_real(rng.standard_normal(shape)))
    up = FFT.ifftn(fu, dealias="3/2-rule")
    check(tuple(up.shape) == (384,) * 3, f"3/2-rule ifftn shape {up.shape}")
    err = rel_err(torch, FFT.fftn(up, dealias="3/2-rule"), fu)
    check(err < 1e-6, f"R2C 256^3 3/2-rule round trip fftn(ifftn(fu)): "
                      f"rel err {err:.3e}")
    w = up * up
    got = FFT.fftn(w, dealias="3/2-rule")
    ref = alias_oracle(torch, w, N, FFT.padsize)
    err = rel_err(torch, got, ref)
    check(err <= 1e-5, f"R2C 256^3 3/2-rule forward of a product field vs "
                       f"the float64 alias-sum oracle: rel err {err:.3e}")
    del got, ref, w
    for k in PADDED_KERNELS:
        check(p3.LAUNCHES[k] > before[k],
              f"3/2-rule 256^3 launched {k}: {p3.LAUNCHES[k] - before[k]}")
    fwd, bwd = FFT.forward_fn("3/2-rule"), FFT.backward_fn("3/2-rule")
    M = (384,) * 3
    k1 = median_ms(torch, lambda: fwd(bwd(fu)), iters=20)
    t1 = median_ms(torch, lambda: torch.fft.rfftn(
        torch.fft.irfftn(fu, s=M)), iters=20)
    t2 = median_ms(torch, lambda: torch.fft.rfftn(
        torch.fft.irfftn(fu, s=M)), iters=20)
    k2 = median_ms(torch, lambda: fwd(bwd(fu)), iters=20)
    print(f"time R2C 256^3 3/2-rule round trip forward_fn(backward_fn(fu)): "
          f"{k1:.4f} / {k2:.4f} ms; torch.fft rfftn(irfftn(fu, s=384^3)) "
          f"float32 (the same FFT sizes, no pad or truncation): "
          f"{t1:.4f} / {t2:.4f} ms", flush=True)
    del fu, up, FFT

    C = C2C(np.array(shape), L, None, "single", device="cuda")
    before = p3.LAUNCHES["fft_last"]
    u = C.shard_real(rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))
    fu = C.fftn(u)
    err = rel_err(torch, fu, torch.fft.fftn(u.to(torch.complex128)))
    check(err <= 1e-5, f"C2C 256^3 fftn vs float64 fftn: rel err {err:.3e}")
    err = rel_err(torch, C.ifftn(fu), u)
    check(err < 1e-6, f"C2C 256^3 ifftn(fftn(u)) round trip: rel err "
                      f"{err:.3e}")
    at384 = p3.LAUNCHES["fft_last"]
    err = rel_err(torch, C.fftn(C.ifftn(fu, dealias="3/2-rule"),
                                dealias="3/2-rule"), fu)
    check(err < 1e-6, f"C2C 256^3 3/2-rule round trip: rel err {err:.3e}")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    w = torch.randn((384,) * 3, generator=g, device="cuda",
                    dtype=torch.complex64)
    ref = fold_full_axes(torch, torch.fft.fftn(w.to(torch.complex128))
                         / C.padsize ** 3, N, (0, 1, 2))
    err = rel_err(torch, C.fftn(w, dealias="3/2-rule"), ref)
    at384 = p3.LAUNCHES["fft_last"] - at384
    check(err <= 1e-5, f"C2C 256^3 3/2-rule forward of a random 384^3 field "
                       f"vs float64 fftn, truncated: rel err {err:.3e}")
    del w, ref
    check(p3.LAUNCHES["fft_last"] > before,
          f"C2C 256^3 launched fft_last: {p3.LAUNCHES['fft_last'] - before}")
    fwd, bwd = C.forward_fn(), C.backward_fn()
    k1 = median_ms(torch, lambda: bwd(fwd(u)))
    t1 = median_ms(torch, lambda: torch.fft.ifftn(torch.fft.fftn(u)))
    t2 = median_ms(torch, lambda: torch.fft.ifftn(torch.fft.fftn(u)))
    k2 = median_ms(torch, lambda: bwd(fwd(u)))
    print(f"time C2C 256^3 round trip backward_fn()(forward_fn()(u)): "
          f"{k1:.4f} / {k2:.4f} ms; torch.fft ifftn(fftn(u)) complex64: "
          f"{t1:.4f} / {t2:.4f} ms", flush=True)
    fwd, bwd = C.forward_fn("3/2-rule"), C.backward_fn("3/2-rule")
    k1 = median_ms(torch, lambda: fwd(bwd(fu)), iters=20)
    t1 = median_ms(torch, lambda: torch.fft.fftn(torch.fft.ifftn(
        fu, s=(384,) * 3)), iters=20)
    t2 = median_ms(torch, lambda: torch.fft.fftn(torch.fft.ifftn(
        fu, s=(384,) * 3)), iters=20)
    k2 = median_ms(torch, lambda: fwd(bwd(fu)), iters=20)
    print(f"time C2C 256^3 3/2-rule round trip forward_fn(backward_fn(fu)): "
          f"{k1:.4f} / {k2:.4f} ms; torch.fft fftn(ifftn(fu, s=384^3)) "
          f"complex64 (the same FFT sizes, no pad or truncation): "
          f"{t1:.4f} / {t2:.4f} ms", flush=True)
    return at384


def make_solver(R2C, NavierStokes3D, precision, layout="complex",
                dealias="2/3-rule"):
    FFT = R2C(np.array([256] * 3), np.array([TAU] * 3), None, precision,
              device="cuda")
    return NavierStokes3D(FFT, nu=NU, dt=DT, dealias=dealias,
                          integrator="RK4", spectral_layout=layout)


def run_steps(torch, p3, s, label, init=None, energy=None, e0=0.125,
              decreasing=True):
    """5 RK4 steps from ``init()`` (Taylor–Green) with the ``energy`` after
    each (held to ``e0`` at t=0, and to decrease strictly when
    ``decreasing``), then the same 5 steps timed (host clock,
    synchronised) with the peak device memory above what was resident
    before them.  Returns the state, the energies, ms per step, the peak
    bytes and the launches of the steps."""
    init, energy = init or s.taylor_green, energy or s.energy
    U0 = init()
    e = [energy(U0)]
    check(abs(e[0] - e0) < 1e-6, f"{label} energy at t=0: {e[0]!r} "
                                 f"(expected {e0!r})")
    steps = dict.fromkeys(p3.LAUNCHES, 0)
    U = U0
    for _ in range(5):
        before = dict(p3.LAUNCHES)
        U = s.step(U)
        for k in steps:
            steps[k] += p3.LAUNCHES[k] - before[k]
        e.append(energy(U))
    print(f"{label} RK4 energies: {e}", flush=True)
    check(all(np.isfinite(e)) and (not decreasing or all(
        a > b for a, b in zip(e, e[1:]))),
          f"{label} energies finite"
          f"{' and strictly decreasing' if decreasing else ''} over 5 steps")
    V = U0                                    # the same 5 steps, timed
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        V = s.step(V)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / 5
    peak = torch.cuda.max_memory_allocated() - resident
    del V
    return U, e, ms_step, peak, steps


def rel_l2(torch, got, ref):
    got = got.to(ref.dtype)
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref))


def solver_phase(torch, p3, R2C, NavierStokes3D):
    """The complex layout; returns its float32 and float64 states after 5
    steps, its ms per step and its peak step memory."""
    s = make_solver(R2C, NavierStokes3D, "single")
    U, _, ms_step, peak, steps = run_steps(torch, p3, s, "NS3D 256^3")
    for k in TRANSFORM_KERNELS:
        check(steps[k] > 0, f"NS3D 256^3 steps launched {k}: {steps[k]}")
    d = make_solver(R2C, NavierStokes3D, "double")
    W = d.taylor_green()
    for _ in range(5):
        W = d.step(W)
    err = rel_l2(torch, U, W)
    check(err <= 1e-5, f"NS3D 256^3 single vs double after 5 steps: "
                       f"rel L2 err {err:.3e}")
    print(f"time NS3D 256^3 RK4 2/3-rule single: {ms_step:.3f} ms/step "
          f"(host clock over 5 steps, synchronised); peak step memory "
          f"{peak / 2**30:.3f} GiB above the resident", flush=True)
    return U, W, ms_step, peak


def packed_solver_phase(torch, p3, R2C, NavierStokes3D, Uc, Ud, ms_c, peak_c):
    """The packed layout: the same 5 steps, held against the complex
    layout's float32 and float64 states."""
    s = make_solver(R2C, NavierStokes3D, "single", "packed")
    U, _, ms_step, peak, steps = run_steps(torch, p3, s, "packed NS3D 256^3")
    for k in PACKED_STEP_KERNELS:
        check(steps[k] > 0, f"packed NS3D 256^3 steps launched {k}: "
                            f"{steps[k]}")
    print(f"packed NS3D 256^3 launches in 5 steps: {steps}", flush=True)
    Up = s.from_packed(U)
    for ref, what in ((Uc, "complex-layout float32"),
                      (Ud, "complex-layout float64")):
        err = rel_l2(torch, Up, ref)
        check(err <= 1e-5, f"packed NS3D 256^3 vs the {what} run after 5 "
                           f"steps: rel L2 err {err:.3e}")
    print(f"time NS3D 256^3 RK4 2/3-rule single: packed {ms_step:.3f} "
          f"ms/step, complex {ms_c:.3f} ms/step (host clock over 5 steps, "
          f"synchronised); peak step memory above the resident: packed "
          f"{peak / 2**30:.3f} GiB, complex {peak_c / 2**30:.3f} GiB",
          flush=True)
    return steps, U


def padded_solver_phase(torch, p3, R2C, NavierStokes3D, ms_c, peak_c):
    """The complex layout with the 3/2 rule: 5 steps against the same run
    in "double", beside the 2/3-rule step."""
    s = make_solver(R2C, NavierStokes3D, "single", dealias="3/2-rule")
    U, _, ms_step, peak, steps = run_steps(torch, p3, s, "3/2-rule NS3D 256^3")
    for k in PADDED_KERNELS:
        check(steps[k] > 0, f"3/2-rule NS3D 256^3 steps launched {k}: "
                            f"{steps[k]}")
    print(f"3/2-rule NS3D 256^3 launches in 5 steps: {steps}", flush=True)
    d = make_solver(R2C, NavierStokes3D, "double", dealias="3/2-rule")
    W = d.taylor_green()
    for _ in range(5):
        W = d.step(W)
    err = rel_l2(torch, U, W)
    check(err <= 1e-5, f"3/2-rule NS3D 256^3 single vs double after 5 steps: "
                       f"rel L2 err {err:.3e}")
    print(f"time NS3D 256^3 RK4 single complex layout: 3/2-rule "
          f"{ms_step:.3f} ms/step, 2/3-rule {ms_c:.3f} ms/step (host clock "
          f"over 5 steps, synchronised); peak step memory above the "
          f"resident: 3/2-rule {peak / 2**30:.3f} GiB, 2/3-rule "
          f"{peak_c / 2**30:.3f} GiB", flush=True)


def family_solver(models, name, precision, layout):
    """The model ``name`` at 256³, RK4, 2/3 rule; with its initial state,
    its total-energy function, that energy at t = 0 and whether it must
    decrease."""
    FFT = models["R2C"](np.array([256] * 3), np.array([TAU] * 3), None,
                        precision, device="cuda")
    kw = dict(dt=DT, dealias="2/3-rule", integrator="RK4",
              spectral_layout=layout)
    if name == "VV":
        s = models[name](FFT, nu=NU, **kw)
        return s, s.taylor_green, s.energy, 0.125, True
    if name == "MHD":
        s = models[name](FFT, nu=NU, eta=NU, **kw)
        return (s, s.taylor_green_mhd, lambda S: sum(s.energies(S)),
                0.125 + 0.00375, True)
    # the buoyancy trades kinetic and potential energy: no monotone total
    s = models[name](FFT, nu=NU, kappa=NU, **kw)
    return (s, s.taylor_green_stratified, lambda S: sum(s.energies(S)),
            0.125 + 0.0025, False)


def family_phase(torch, p3, models, Uc, Ud):
    """VV, MHD and Boussinesq at 256³: 5 RK4 steps in each layout against
    the model's float64 complex run, VV against the curl of NS3D's states
    (``Uc`` float32, ``Ud`` float64, phase 4), MHD's ∇·b, and each packed
    right-hand side's launches."""
    for name in FAMILY_RHS:
        d, init, *_ = family_solver(models, name, "double", "complex")
        W = init()
        for _ in range(5):
            W = d.step(W)
        if name == "VV":
            err = rel_l2(torch, W, d.from_velocity(Ud))
            check(err <= 1e-10, f"VV 256^3 float64 vs the curl of NS3D's "
                                f"float64 state after 5 steps: rel L2 err "
                                f"{err:.3e}")
        times = {}
        for layout in ("complex", "packed"):
            s, init, energy, e0, dec = family_solver(models, name, "single",
                                                     layout)
            label = f"{name} {layout} 256^3"
            S, _, ms, peak, steps = run_steps(torch, p3, s, label, init,
                                              energy, e0, dec)
            times[layout] = (ms, peak)
            print(f"{label} launches per step: "
                  f"{ {k: n / 5 for k, n in steps.items() if n} }",
                  flush=True)
            if layout == "packed":
                for k, n in steps.items():
                    want = 4 * 5 * FAMILY_RHS[name].get(k, 0)
                    check(n == want, f"{label} launched {k} {n} times in 5 "
                                     f"RK4 steps (4 x 5 x its count in one "
                                     f"right-hand side: {want})")
            else:
                for k in TRANSFORM_KERNELS:
                    check(steps[k] > 0, f"{label} steps launched {k}: "
                                        f"{steps[k]}")
            Sc = s.from_packed(S) if layout == "packed" else S
            err = rel_l2(torch, Sc, W)
            check(err <= 1e-5, f"{label} vs the float64 complex run after 5 "
                               f"steps: rel L2 err {err:.3e}")
            if name == "VV":
                err = rel_l2(torch, Sc, s.from_velocity(Uc))
                check(err <= 1e-5, f"{label} vs the curl of NS3D's float32 "
                                   f"state after 5 steps: rel L2 err "
                                   f"{err:.3e}")
            if name == "MHD":
                b = S[:, 3:] if layout == "packed" else S[3:]
                kmax = max(float(k.abs().max()) for k in s._step_args()[:3])
                rel = s.divergences(S)[1] / (kmax * float(b.abs().max()))
                check(rel <= 1e-6, f"{label} max |K.b| / (max |K| max |b|) "
                                   f"after 5 steps: {rel:.3e}")
            del S, Sc
        print(f"time {name} 256^3 RK4 2/3-rule single: packed "
              f"{times['packed'][0]:.3f} ms/step, complex "
              f"{times['complex'][0]:.3f} ms/step (host clock over 5 steps, "
              f"synchronised); peak step memory above the resident: packed "
              f"{times['packed'][1] / 2**30:.3f} GiB, complex "
              f"{times['complex'][1] / 2**30:.3f} GiB", flush=True)
        del d, W


def line_phase(torch, LineR2C, rng):
    """``line.R2C`` at 1024² and 2048², "single" and "double": the forward
    (None, 2/3 rule) against float64 ``torch.fft.rfft2`` at 1e-5 (1e-12 in
    "double"), and round trips at 1e-6 (1e-12) relative: physical
    ``ifft2(fft2(u))`` for None, spectral ``fft2(ifft2(fu))`` under the 2/3
    and the 3/2 rule (the latter through the 1.5n grid)."""
    for n in (1024, 2048):
        for precision, tol, ftol in (("single", 1e-6, 1e-5),
                                     ("double", 1e-12, 1e-12)):
            FFT = LineR2C(np.array([n, n]), np.array([TAU] * 2), None,
                          precision, device="cuda")
            lab = f"line.R2C {n}^2 {precision}"
            u = FFT.shard_real(rng.standard_normal((n, n)))
            ref = torch.fft.rfft2(u.double())
            fu = FFT.fft2(u)
            check(rel_err(torch, fu, ref) <= ftol,
                  f"{lab} fft2 vs float64 rfft2: rel err "
                  f"{rel_err(torch, fu, ref):.3e}")
            err = rel_err(torch, FFT.ifft2(fu), u)
            check(err < tol, f"{lab} ifft2(fft2(u)): rel err {err:.3e}")
            fu23 = FFT.fft2(u, dealias="2/3-rule")
            err = float((fu23 - ref * FFT.get_dealias_filter()).abs().max()
                        / ref.abs().max())
            check(err <= ftol, f"{lab} 2/3-rule fft2 vs masked float64 "
                               f"rfft2: rel err {err:.3e}")
            for dealias, spec in (("2/3-rule", fu23), ("3/2-rule", fu)):
                back = FFT.ifft2(spec, dealias=dealias)
                err = rel_err(torch, FFT.fft2(back, dealias=dealias), spec)
                check(err < tol, f"{lab} {dealias} fft2(ifft2(fu)) on "
                                 f"{tuple(back.shape)}: rel err {err:.3e}")
            del FFT, u, ref, fu, fu23, back


def event_ms_per_step(torch, s, U, steps=5):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(steps):
        U = s.step(U)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / steps


def ns2d_phase(torch, p3, LineR2C, NavierStokes2D):
    """NS2D RK4 from the vortex pair, 5 steps: packed 1024² (DIF lanes)
    and 1024 x 2048 (natural lanes, h = 1024), complex 1024², 2048² and
    1024 x 2048 in float32, each against the float64 complex run; the
    packed steps' exact launches."""
    def solver(shape, precision, layout):
        FFT = LineR2C(np.array(shape), np.array([TAU] * 2), None, precision,
                      device="cuda")
        return NavierStokes2D(FFT, nu=NU2D, dt=DT2D, spectral_layout=layout)

    times = {}
    for shape, layouts in (((1024, 1024), ("packed", "complex")),
                           ((2048, 2048), ("complex",)),
                           ((1024, 2048), ("packed", "complex"))):
        n = "x".join(map(str, shape)) if shape[0] != shape[1] \
            else f"{shape[0]}^2"
        d = solver(shape, "double", "complex")
        W = d.vortex_pair()
        for _ in range(5):
            W = d.step(W)
        states = {}
        for layout in layouts:
            s = solver(shape, "single", layout)
            label = f"NS2D {layout} {n}"
            S, _, ms, peak, steps = run_steps(
                torch, p3, s, label, s.vortex_pair, s.enstrophy,
                Z0_VORTEX_PAIR)
            ev = event_ms_per_step(torch, s, S)
            times[label] = (ms, ev, peak)
            print(f"{label} launches per step: "
                  f"{ {k: v / 5 for k, v in steps.items() if v} }",
                  flush=True)
            if layout == "packed":
                rhs = NS2D_RHS if s._dif else NS2D_RHS_NATURAL
                for k, v in steps.items():
                    want = 4 * 5 * rhs.get(k, 0)
                    check(v == want, f"{label} launched {k} {v} times in 5 "
                                     f"RK4 steps (4 x 5 x its count in one "
                                     f"right-hand side: {want})")
                S = s.unpack_state(S)
            states[layout] = S
            err = rel_l2(torch, S, W)
            check(err <= 1e-5, f"{label} vs the float64 complex run after 5 "
                               f"steps: rel L2 err {err:.3e}")
        if len(states) == 2:
            err = rel_l2(torch, states["packed"], states["complex"])
            check(err <= 1e-5, f"NS2D {n} packed state (unpacked) vs the "
                               f"complex one after 5 steps: rel L2 err "
                               f"{err:.3e}")
        del d, W, states
    for label, (ms, ev, peak) in times.items():
        print(f"time {label} RK4 2/3-rule single: {ms:.3f} ms/step (host "
              f"clock over 5 steps, synchronised), {ev:.3f} ms/step (CUDA "
              f"events over 5 steps); peak step memory "
              f"{peak / 2**20:.2f} MiB above the resident", flush=True)


def serial_phase(torch, p3, T):
    """``serialFFT.rfftn``/``irfftn`` at 640³ float32 (radix 5 on every
    axis: x, y = 640 and the half-length z h = 320) through the
    hand-written chain: against float64 ``torch.fft.rfftn``, the round
    trip, the launches, and the time beside ``torch.fft``'s."""
    n = 640
    shape = (n, n, n)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    u = torch.randn(shape, generator=g, device="cuda")
    before = dict(p3.LAUNCHES)
    fu = T.rfftn(u)
    err = rel_err(torch, fu, torch.fft.rfftn(u.double()))
    check(err <= 1e-5, f"serialFFT rfftn 640^3 vs float64 torch.fft.rfftn: "
                       f"rel err {err:.3e}")
    err = rel_err(torch, T.irfftn(fu, s=shape), u)
    check(err < 1e-6, f"serialFFT irfftn(rfftn(u)) 640^3 round trip: rel "
                      f"err {err:.3e}")
    for k in TRANSFORM_KERNELS:
        check(p3.LAUNCHES[k] > before[k],
              f"serialFFT 640^3 launched {k}: {p3.LAUNCHES[k] - before[k]}")
    k1 = median_ms(torch, lambda: T.irfftn(T.rfftn(u), s=shape), 10)
    t1 = median_ms(torch, lambda: torch.fft.irfftn(torch.fft.rfftn(u),
                                                   s=shape), 10)
    t2 = median_ms(torch, lambda: torch.fft.irfftn(torch.fft.rfftn(u),
                                                   s=shape), 10)
    k2 = median_ms(torch, lambda: T.irfftn(T.rfftn(u), s=shape), 10)
    print(f"time serialFFT 640^3 irfftn(rfftn(u)): {k1:.4f} / {k2:.4f} ms; "
          f"torch.fft irfftn(rfftn(u)) float32: {t1:.4f} / {t2:.4f} ms",
          flush=True)


def dense_phase(torch, p3, dn):
    """The dense tier at 256³, composed as benchmarks/pallas_tuning.py
    composes it: ``rfft_last`` -> ``fft_axis(1)`` -> ``fft_axis(0)`` against
    float64 ``rfftn``, row 20 (``fft_axis`` on the last axis of that
    spectrum) against float64 ``fft``, and back to the 1e-6 round trip;
    the chain's time beside ``torch.fft``'s."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    u = torch.randn((256, 256, 256), generator=g, device="cuda")

    def fwd(x):
        return dn.fft_axis(dn.fft_axis(dn.rfft_last(x), 1), 0)

    def bwd(X):
        return dn.irfft_last(dn.fft_axis(dn.fft_axis(X, 0, True), 1, True),
                             256)

    X = fwd(u)
    err = rel_err(torch, X, torch.fft.rfftn(u.double()))
    check(err <= 1e-5, f"dense 256^3 chain vs float64 rfftn: rel err "
                       f"{err:.3e}")
    err = rel_err(torch, dn.fft_axis(X, 2),
                  torch.fft.fft(X.to(torch.complex128), dim=2))
    check(err <= 1e-5, f"dense fft_axis(axis=-1) on the (256, 256, 129) "
                       f"spectrum vs float64 fft: rel err {err:.3e}")
    err = rel_err(torch, dn.fft_axis(dn.fft_axis(X, 2), 2, True), X)
    check(err < 1e-6, f"dense last-axis round trip (n = 129): rel err "
                      f"{err:.3e}")
    err = rel_err(torch, bwd(X), u)
    check(err < 1e-6, f"dense 256^3 round trip: rel err {err:.3e}")
    for k in ("dense_fft_axis", "dense_fft_last", "dense_rfft_last",
              "dense_irfft_last"):
        check(p3.LAUNCHES[k] > 0, f"dense 256^3 launched {k}: "
                                  f"{p3.LAUNCHES[k]}")
    k1 = median_ms(torch, lambda: bwd(fwd(u)))
    t1 = median_ms(torch, lambda: torch.fft.irfftn(torch.fft.rfftn(u),
                                                   s=u.shape))
    t2 = median_ms(torch, lambda: torch.fft.irfftn(torch.fft.rfftn(u),
                                                   s=u.shape))
    k2 = median_ms(torch, lambda: bwd(fwd(u)))
    print(f"time dense 256^3 chain round trip (6 launches): {k1:.4f} / "
          f"{k2:.4f} ms; torch.fft irfftn(rfftn(u)): {t1:.4f} / {t2:.4f} "
          f"ms", flush=True)


def wide_packed_phase(torch, p3, R2C, NavierStokes3D, steps256):
    """Packed NS3D at WIDE (320, 320, 1280; refused before the kernels
    took the reference's envelope): 5 RK4 steps from Taylor–Green, the
    hand-written launches a step equal to the 256³ packed step's
    (``steps256``, 5 steps), the energy decaying, the state against the
    complex layout's after the same steps (1e-5 relative L2, as at 256³),
    ms per step and peak memory.  dt = DT / 2 keeps max |k|·|u|·dt (k2 up
    to 426 under the 2/3 rule, |u| <= 1) inside RK4's stability bound of
    2.8 on the imaginary axis."""
    def solver(layout):
        FFT = R2C(np.array(WIDE), np.array([TAU] * 3), None, "single",
                  device="cuda")
        return NavierStokes3D(FFT, nu=NU, dt=DT / 2, dealias="2/3-rule",
                              integrator="RK4", spectral_layout=layout)

    label = "packed NS3D 320x320x1280"
    s = solver("packed")
    U, _, ms, peak, steps = run_steps(torch, p3, s, label)
    check(steps == steps256, f"{label} launches in 5 steps {steps} equal "
                             f"the 256^3 packed step's")
    c = solver("complex")
    Uc, _, ms_c, peak_c, _ = run_steps(torch, p3, c, "NS3D complex "
                                                     "320x320x1280")
    err = rel_l2(torch, s.from_packed(U), Uc)
    check(err <= 1e-5, f"{label} vs the complex layout after 5 steps: rel "
                       f"L2 err {err:.3e}")
    print(f"time NS3D 320x320x1280 RK4 2/3-rule single: packed {ms:.3f} "
          f"ms/step, complex {ms_c:.3f} ms/step (host clock over 5 steps, "
          f"synchronised); peak step memory above the resident: packed "
          f"{peak / 2**30:.3f} GiB, complex {peak_c / 2**30:.3f} GiB",
          flush=True)


def _dist_counts(p3, rdma):
    return {**p3.LAUNCHES, **rdma.LAUNCHES}


def _reset_counts(p3, rdma):
    p3.reset_launches()
    rdma.reset_launches()


def dist_child(rank, q, P, store, ns_file):
    """One rank of phase 12 (a spawned process on cuda:0, a gloo group of
    P): the main path's distributed calls under ``communication="rdma"``,
    each with the launch counts set to 0 just before it and read just
    after; rank 0 holds the gathered results against the P == 1 kernel
    path (a world-of-one group on the same card) and float64
    ``torch.fft``.  Puts (rank, results) or (rank, traceback) on ``q``."""
    import traceback
    try:
        q.put((rank, _dist_child(rank, P, store, ns_file)))
    except BaseException:
        q.put((rank, traceback.format_exc()))


def _dist_child(rank, P, store, ns_file):
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    from mpifft4py_tpu_torch.models import NavierStokes3D
    from mpifft4py_tpu_torch.ops import fft3d as p3
    from mpifft4py_tpu_torch.parallel import rdma
    from mpifft4py_tpu_torch.slab import C2C, R2C
    torch.cuda.set_device(0)

    def sync():
        torch.cuda.synchronize()

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to("cuda")

    dist.init_process_group("gloo", store=dist.FileStore(store, P),
                            rank=rank, world_size=P)
    one = [dist.new_group([r]) for r in range(P)]    # a world of one each
    out = {"checks": [], "counts": {}, "times": {}}
    n = 256
    N, L = np.array([n] * 3), np.array([TAU] * 3)

    def note(ok, what):
        out["checks"].append((bool(ok), f"P={P} rank {rank}: {what}"))

    def main_path(label, fn):
        sync()
        _reset_counts(p3, rdma)
        res = fn()
        sync()
        out["counts"][label] = _dist_counts(p3, rdma)
        return res

    rng = np.random.default_rng(SEED + 12)
    u = rng.standard_normal((n,) * 3).astype(np.float32)
    F = R2C(N, L, None, "single", communication="rdma", device="cuda")
    F1 = R2C(N, L, one[rank], "single", device="cuda")
    ul = F.shard_real(u)

    # R2C: forward, round trip, 2/3 rule; rows 24-25 and row 23
    fu = main_path("R2C forward", lambda: F.fftn(ul))
    back = main_path("R2C backward", lambda: F.ifftn(fu))
    note(rel_err(torch, back, ul) < 1e-6, f"R2C {n}^3 round trip rel err "
         f"{rel_err(torch, back, ul):.3e}")
    f23 = main_path("R2C 2/3 forward", lambda: F.fftn(ul, dealias="2/3-rule"))
    g, g23 = F.gather(fu), F.gather(f23)
    if rank == 0:
        ug = dev(u)
        for got, ref, what in (
                (g, F1.fftn(ug), "forward vs the P == 1 kernel path"),
                (g23, F1.fftn(ug, dealias="2/3-rule"),
                 "2/3-rule forward vs the P == 1 kernel path")):
            err = rel_err(torch, dev(got), ref)
            note(err <= 1e-6, f"R2C {n}^3 {what}: rel err {err:.3e}")
        ref = torch.fft.rfftn(ug.double())
        err = rel_err(torch, dev(g).to(ref.dtype), ref)
        note(err <= 2e-6, f"R2C {n}^3 forward vs float64 rfftn: rel err "
                          f"{err:.3e}")
        del ug, ref
    del g, g23, f23

    # the 3/2 rule through row 23: the forward from the padded grid
    m = 3 * n // 2
    u3 = rng.standard_normal((m,) * 3).astype(np.float32)
    f32 = main_path("R2C 3/2 forward",
                    lambda: F.fftn(F.shard_real(u3), dealias="3/2-rule"))
    g32 = F.gather(f32)
    if rank == 0:
        ref = F1.fftn(dev(u3), dealias="3/2-rule")
        err = rel_err(torch, dev(g32), ref)
        note(err <= 1e-6, f"R2C {n}^3 3/2-rule forward vs the P == 1 kernel "
                          f"path: rel err {err:.3e}")
        del ref
    del u3, f32, g32

    # C2C round trip (row 23)
    C = C2C(N, L, None, "single", communication="rdma", device="cuda")
    uc = C.shard_real(u + 1j * u[::-1])
    cb = main_path("C2C round trip", lambda: C.ifftn(C.fftn(uc)))
    note(rel_err(torch, cb, uc) < 1e-6, f"C2C {n}^3 round trip rel err "
         f"{rel_err(torch, cb, uc):.3e}")
    del C, uc, cb

    # times: the R2C round trip (host clock, every rank synchronised)
    fwd, bwd = F.forward_fn(), F.backward_fn()
    for _ in range(2):
        bwd(fwd(ul))
    sync()
    dist.barrier()
    f0, t0 = F._peers.fence_seconds, time.perf_counter()
    for _ in range(10):
        bwd(fwd(ul))
    sync()
    wall = time.perf_counter() - t0
    out["times"]["R2C round trip ms"] = wall * 1e3 / 10
    out["times"]["R2C round trip fence share"] = \
        (F._peers.fence_seconds - f0) / wall
    del fu, back, ul, F, F1, fwd, bwd

    if ns_file is not None:
        out.update(_dist_ns3d(torch, NavierStokes3D, R2C, p3, rdma, ns_file,
                              note, main_path, N, L, sync, dev))
    # drop the peers' mapped buffers on every rank before any rank exits
    gc.collect()
    sync()
    dist.barrier()
    dist.destroy_process_group()
    return out


def _dist_ns3d(torch, NavierStokes3D, R2C, p3, rdma, ns_file, note,
               main_path, N, L, sync, dev):
    """Packed NS3D, RK4, 5 steps from Taylor–Green under "rdma": the
    energy decays, each step launches exactly 4 x DIST_RHS (on the card),
    and the state is held against phase 5's P == 1 state (rel L2 1e-5 over
    the group)."""
    import torch.distributed as dist
    FFT = R2C(N, L, None, "single", communication="rdma", device="cuda")
    s = NavierStokes3D(FFT, nu=NU, dt=DT, dealias="2/3-rule",
                       integrator="RK4", spectral_layout="packed")
    U0 = s.taylor_green()
    e = [s.energy(U0)]
    U = U0
    steps = []
    for i in range(5):
        U = main_path(f"NS3D step {i}", lambda: s.step(U))
        steps.append(_dist_counts(p3, rdma))
        e.append(s.energy(U))
    want = {k: 4 * c for k, c in DIST_RHS.items() if c}
    for i, c in enumerate(steps):
        got = {k: v for k, v in c.items() if v}
        note(got == want,
             f"packed NS3D step {i} launches {got} (expected {want})")
    note(all(a > b for a, b in zip(e, e[1:])) and abs(e[0] - 0.125) < 1e-6,
         f"packed NS3D energies {e} start at 0.125 and decrease")
    ref = dev(FFT._cut(np.load(ns_file), "packed"))
    num = FFT._all_reduce(((U - ref) ** 2).sum().double())
    den = FFT._all_reduce((ref ** 2).sum().double())
    err = float(torch.sqrt(num / den))
    note(err <= 1e-5, f"packed NS3D {int(N[0])}^3 after 5 steps vs the "
                      f"P == 1 packed state (phase 5): rel L2 err {err:.3e}")
    sync()
    dist.barrier()
    f0, t0 = FFT._peers.fence_seconds, time.perf_counter()
    V = U0
    for _ in range(5):
        V = s.step(V)
    sync()
    wall = time.perf_counter() - t0
    return {"ns_times": {"ms/step": wall * 1e3 / 5,
                         "fence share": (FFT._peers.fence_seconds - f0)
                         / wall}}


def _build_tmp():
    """A fresh directory under build/ (gitignored) for the ranks' files."""
    import tempfile
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    return tempfile.mkdtemp(dir=os.path.join(HERE, "build"))


def run_ranks(P, target, args, label, launches):
    """``target(rank, q, *args)`` in P spawned processes (ranks on
    cuda:0): every check and launch count of a rank comes back here, and a
    rank's failure fails the run.  Returns rank 0's result dict (None if it
    failed)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, q) + tuple(args))
             for r in range(P)]
    for p in procs:
        p.start()
    got = {}
    for _ in procs:
        try:
            r, res = q.get(timeout=QTIMEOUT)
        except Exception:
            break
        got[r] = res
    for p in procs:
        p.join(60)
        if p.is_alive():
            p.terminate()
            p.join(10)
    check(sorted(got) == list(range(P)) and all(
        isinstance(v, dict) for v in got.values()) and all(
        p.exitcode == 0 for p in procs),
          f"{label}: every rank ran to its end (exit codes "
          f"{[p.exitcode for p in procs]})")
    for r in sorted(got):
        res = got[r]
        if not isinstance(res, dict):
            print(f"{label} rank {r} failed:\n{res}", flush=True)
            continue
        for ok, what in res["checks"]:
            check(ok, what)
        for lbl, counts in res["counts"].items():
            for k, c in counts.items():
                launches[k] += c
            if r == 0:
                print(f"{label} {lbl} launches (rank 0): "
                      f"{ {k: c for k, c in counts.items() if c} }",
                      flush=True)
    return got[0] if isinstance(got.get(0), dict) else None


def dist_phase(torch, launches, U_packed):
    """Phase 12: the distributed slab on one card.  P = 2, then P = 4,
    ranks spawned on cuda:0 with a gloo group (NCCL refuses two ranks on
    one card) and ``communication="rdma"``.  The P = 2 ranks also step
    packed NS3D, against ``U_packed`` (phase 5's state, handed over in a
    file under build/)."""
    tmp = _build_tmp()
    ns_file = None
    if U_packed is not None:
        ns_file = os.path.join(tmp, "ns3d_p1.npy")
        np.save(ns_file, U_packed.cpu().numpy())
    for P in (2, 4):
        t0 = time.perf_counter()
        res = run_ranks(P, dist_child, (P, os.path.join(tmp, f"store{P}"),
                                        ns_file if P == 2 else None),
                       f"phase 12 P={P}", launches)
        if res is not None:
            print(f"time phase 12 P={P} (ranks time-slicing one card; not a "
                  f"scaling figure): R2C 256^3 rdma round trip "
                  f"{res["times"]["R2C round trip ms"]:.3f} ms, fence "
                  f"(synchronise + barrier) share "
                  f"{res['times']['R2C round trip fence share']:.3f}"
                  + ("" if "ns_times" not in res else
                     f"; packed NS3D 256^3 RK4 "
                     f"{res['ns_times']['ms/step']:.3f} ms/step, fence share "
                     f"{res['ns_times']['fence share']:.3f}")
                  + f"; phase wall {time.perf_counter() - t0:.1f} s",
                  flush=True)
    shutil.rmtree(tmp)


# -- phase 13: the pencil on one card -------------------------------------------------

def pencil_child(rank, q, store, files):
    """One rank of phase 13 (a spawned process on cuda:0, a gloo group of
    4, ``communication="rdma"``): the pencil's main-path calls on the 2x2,
    4x1 and 1x4 grids, each with the launch counts set to 0 just before it
    and read just after.  Puts (rank, results) or (rank, traceback) on
    ``q``."""
    import traceback
    try:
        q.put((rank, _pencil_child(rank, store, files)))
    except BaseException:
        q.put((rank, traceback.format_exc()))


def _fence_seconds(F):
    peers = {id(p): p for p in (F._peers, F._ride1[1], F._ride2[1])
             if p is not None}      # a sub-group spanning the grid rides F's
    return sum(p.fence_seconds for p in peers.values())


def _pencil_child(rank, store, files):
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    from mpifft4py_tpu_torch import pencil
    from mpifft4py_tpu_torch.models import NavierStokes3D
    from mpifft4py_tpu_torch.ops import fft3d as p3
    from mpifft4py_tpu_torch.parallel import rdma
    from mpifft4py_tpu_torch.slab import R2C as SlabR2C
    P, shape = 4, (256,) * 3
    torch.cuda.set_device(0)

    def sync():
        torch.cuda.synchronize()

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to("cuda")

    dist.init_process_group("gloo", store=dist.FileStore(store, P),
                            rank=rank, world_size=P)
    one = [dist.new_group([r]) for r in range(P)]    # a world of one each
    out = {"checks": [], "counts": {}, "times": {}}
    N, L = np.array(shape), np.array([TAU] * 3)
    tag = "x".join(str(n) for n in shape)

    def note(ok, what):
        out["checks"].append((bool(ok), f"phase 13 rank {rank}: {what}"))

    def main_path(label, fn):
        sync()
        _reset_counts(p3, rdma)
        res = fn()
        sync()
        out["counts"][label] = _dist_counts(p3, rdma)
        return res

    def make(P1, cls=pencil.R2C, **kw):
        return cls(N, L, None, "single", P1=P1, communication="rdma",
                   device="cuda", **kw)

    def round_trip(F, u, what, dealias=None):
        back = main_path(f"{what} round trip", lambda: F.ifftn(
            F.fftn(u, dealias=dealias), dealias=dealias))
        err = rel_err(torch, back, u)
        note(err < 1e-6, f"{what} {tag} round trip rel err {err:.3e}")

    rng = np.random.default_rng(SEED + 13)
    u = rng.standard_normal(shape).astype(np.float32)
    F = make(2)
    S1 = SlabR2C(N, L, one[rank], "single", device="cuda")   # P == 1
    nf = F.Nf
    ul = F.shard_real(u)

    # 2x2 R2C: rows 8, 26, 24 forward; 25, 27, 9 back
    fu = main_path("2x2 R2C forward", lambda: F.fftn(ul))
    back = main_path("2x2 R2C backward", lambda: F.ifftn(fu))
    err = rel_err(torch, back, ul)
    note(err < 1e-6, f"2x2 R2C {tag} round trip rel err {err:.3e}")
    f23 = main_path("2x2 R2C 2/3 forward",
                    lambda: F.fftn(ul, dealias="2/3-rule"))
    g, g23 = F.gather(fu), F.gather(f23)
    del fu, back, f23
    if rank == 0:
        note(np.all(g[..., nf:] == 0), f"2x2 R2C forward: the alignment "
                                       f"lanes {nf}..{F.Nfp - 1} are 0")
        ug = dev(u)
        ref = torch.fft.rfftn(ug.double())
        err = rel_err(torch, dev(g[..., :nf]).to(ref.dtype), ref)
        note(err <= 2e-6, f"2x2 R2C {tag} forward vs float64 rfftn: rel err "
                          f"{err:.3e}")
        del ref
        err = rel_err(torch, dev(g23[..., :nf]),
                      S1.fftn(ug, dealias="2/3-rule"))
        note(err <= 1e-6, f"2x2 R2C {tag} 2/3-rule forward vs the P == 1 "
                          f"slab path: rel err {err:.3e}")
        del ug
    del g, g23

    # the 3/2 rule (row 23 stages): forward and round trip
    u3 = rng.standard_normal(tuple(3 * n // 2 for n in shape)).astype(
        np.float32)
    f32 = main_path("2x2 R2C 3/2 forward",
                    lambda: F.fftn(F.shard_real(u3), dealias="3/2-rule"))
    b32 = main_path("2x2 R2C 3/2 backward",
                    lambda: F.ifftn(f32, dealias="3/2-rule"))
    g32, gb32 = F.gather(f32), F.gather(b32)
    del f32, b32
    if rank == 0:
        r32 = S1.fftn(dev(u3), dealias="3/2-rule")
        err = rel_err(torch, dev(g32[..., :nf]), r32)
        note(err <= 1e-6, f"2x2 R2C {tag} 3/2-rule forward vs the P == 1 "
                          f"slab path: rel err {err:.3e}")
        err = rel_err(torch, dev(gb32), S1.ifftn(r32, dealias="3/2-rule"))
        note(err <= 1e-6, f"2x2 R2C {tag} 3/2-rule round trip vs the P == 1 "
                          f"slab path: rel err {err:.3e}")
        del r32
    del u3, g32, gb32

    FY = make(2, alignment="Y")
    round_trip(FY, FY.shard_real(u), "2x2 R2C alignment Y")
    C = make(2, cls=pencil.C2C)
    round_trip(C, C.shard_real(u + 1j * u[::-1]), "2x2 C2C")
    F14 = make(1)
    round_trip(F14, F14.shard_real(u), "1x4 R2C")
    F41 = make(4)
    u41 = F41.shard_real(u)
    pk = main_path("4x1 packed round trip", lambda: F41.backward_packed_fn()(
        F41.forward_packed_fn()(u41)))
    err = rel_err(torch, pk, u41)
    note(err < 1e-6, f"4x1 packed interface {tag} round trip rel err "
                     f"{err:.3e}")
    del FY, C, F14, F41, u41, pk

    # times: the 2x2 R2C round trip (host clock, every rank synchronised)
    fwd, bwd = F.forward_fn(), F.backward_fn()
    for _ in range(2):
        bwd(fwd(ul))
    sync()
    dist.barrier()
    f0, t0 = _fence_seconds(F), time.perf_counter()
    for _ in range(10):
        bwd(fwd(ul))
    sync()
    wall = time.perf_counter() - t0
    out["times"]["R2C round trip ms"] = wall * 1e3 / 10
    out["times"]["R2C round trip fence share"] = \
        (_fence_seconds(F) - f0) / wall
    del ul, fwd, bwd

    # NS3D on the 2x2 pencil, both layouts (packed = WIDE)
    refs = {"complex": np.load(files["complex"]),
            "packed": np.load(files["packed"])}
    refs["complex"] = np.pad(refs["complex"],
                             [(0, 0)] * 3 + [(0, F.Nfp - nf)])
    rhs = {"complex": PENCIL_COMPLEX_RHS, "packed": PENCIL_PACKED_RHS}
    for layout in ("complex", "packed"):
        s = NavierStokes3D(F, nu=NU, dt=DT, dealias="2/3-rule",
                           integrator="RK4", spectral_layout=layout)
        U0 = s.taylor_green()
        e = [s.energy(U0)]
        U, steps = U0, []
        for i in range(5):
            U = main_path(f"NS3D {layout} step {i}", lambda: s.step(U))
            steps.append(_dist_counts(p3, rdma))
            e.append(s.energy(U))
        want = {k: 4 * c for k, c in rhs[layout].items()}
        for i, c in enumerate(steps):
            got = {k: v for k, v in c.items() if v}
            note(got == want,
                 f"{layout} NS3D step {i} launches {got} (expected {want})")
        note(all(a > b for a, b in zip(e, e[1:]))
             and abs(e[0] - 0.125) < 1e-6,
             f"{layout} NS3D energies {e} start at 0.125 and decrease")
        ref = dev(F._cut(refs[layout], layout))
        num = F._all_reduce(((U - ref).abs() ** 2).sum().double())
        den = F._all_reduce((ref.abs() ** 2).sum().double())
        err = float(torch.sqrt(num / den))
        note(err <= 1e-5, f"{layout} NS3D {tag} on 2x2 after 5 steps vs "
                          f"the P == 1 {layout} state (phase "
                          f"{4 if layout == 'complex' else 5}): rel L2 err "
                          f"{err:.3e}")
        sync()
        dist.barrier()
        f0, t0 = _fence_seconds(F), time.perf_counter()
        V = U0
        for _ in range(5):
            V = s.step(V)
        sync()
        wall = time.perf_counter() - t0
        out["times"][f"NS3D {layout} ms/step"] = wall * 1e3 / 5
        out["times"][f"NS3D {layout} fence share"] = \
            (_fence_seconds(F) - f0) / wall
        del s, U0, U, V, ref
    # drop the peers' mapped buffers on every rank before any rank exits
    del F, S1
    gc.collect()
    sync()
    dist.barrier()
    dist.destroy_process_group()
    return out


def pencil_phase(torch, launches, Uc, U_packed):
    """Phase 13: the pencil on one card: 4 ranks spawned on cuda:0, a gloo
    group, ``communication="rdma"`` (rows 23-27 over CUDA IPC), the 2x2,
    4x1 and 1x4 grids built from the same ranks; NS3D on 2x2 against
    ``Uc``/``U_packed`` (phases 4/5's P == 1 states, handed over in files
    under build/)."""
    tmp = _build_tmp()
    files = {}
    for name, U in (("complex", Uc), ("packed", U_packed)):
        files[name] = os.path.join(tmp, f"ns3d_{name}.npy")
        np.save(files[name], U.cpu().numpy())
    t0 = time.perf_counter()
    res = run_ranks(4, pencil_child, (os.path.join(tmp, "store"), files),
                    "phase 13", launches)
    if res is not None:
        t = res["times"]
        tag = "256x256x256"
        print(f"time phase 13 (4 ranks time-slicing one card; not a scaling "
              f"figure): 2x2 pencil R2C {tag} rdma round trip "
              f"{t['R2C round trip ms']:.3f} ms, fence (synchronise + "
              f"barrier) share {t['R2C round trip fence share']:.3f}; NS3D "
              f"{tag} RK4 on 2x2: complex {t['NS3D complex ms/step']:.3f} "
              f"ms/step, fence share {t['NS3D complex fence share']:.3f}; "
              f"packed (WIDE) {t['NS3D packed ms/step']:.3f} ms/step, fence "
              f"share {t['NS3D packed fence share']:.3f}; phase wall "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(tmp)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import mpifft4py_tpu_torch as T
    from mpifft4py_tpu_torch.ops import _build, dense as dn, fft3d as p3
    from mpifft4py_tpu_torch.ops import zdif as zd
    from mpifft4py_tpu_torch.parallel import rdma
    from mpifft4py_tpu_torch.line import R2C as LineR2C
    from mpifft4py_tpu_torch.slab import C2C, R2C
    from mpifft4py_tpu_torch.models import (Boussinesq3D, MHD3D,
                                            NavierStokes2D, NavierStokes3D,
                                            VorticityVelocity3D)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {name}", flush=True)

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.last_build_seconds} s) into {_build.build_dir()}",
          flush=True)
    for line in _build.ptxas_report().splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print("ptxas " + line.split(":", 1)[-1].strip(), flush=True)

    rng = np.random.default_rng(SEED)
    kern = kernel_phase(torch, p3, zd, dn, rng)
    kern.update(peer_kernel_phase(torch, rdma, rng))
    envelope_phase(torch, p3, dn)

    # the main path: each of its paths runs with the counts set to 0 just
    # before it and read just after
    launches = dict.fromkeys(_dist_counts(p3, rdma), 0)

    def path(phase, *args):
        _reset_counts(p3, rdma)
        out = phase(*args)
        for k, n in _dist_counts(p3, rdma).items():
            launches[k] += n
        return out

    path(transform_phase, torch, p3, R2C, rng)
    # row 10 at n = 384: the 3/2-rule C2C calls' fft_last launches
    launches["fft_last_384"] = path(padded_transform_phase, torch, p3, R2C,
                                    C2C, rng)
    Uc, Ud, ms_c, peak_c = path(solver_phase, torch, p3, R2C, NavierStokes3D)
    steps256, U_packed = path(packed_solver_phase, torch, p3, R2C,
                              NavierStokes3D, Uc, Ud, ms_c, peak_c)
    path(padded_solver_phase, torch, p3, R2C, NavierStokes3D, ms_c, peak_c)
    path(family_phase, torch, p3, {"R2C": R2C, "VV": VorticityVelocity3D,
                                   "MHD": MHD3D, "Boussinesq": Boussinesq3D},
         Uc, Ud)
    del Ud
    path(line_phase, torch, LineR2C, rng)
    path(ns2d_phase, torch, p3, LineR2C, NavierStokes2D)
    path(serial_phase, torch, p3, T)
    path(dense_phase, torch, p3, dn)
    path(wide_packed_phase, torch, p3, R2C, NavierStokes3D, steps256)
    # phases 12-13: the children count their own main-path launches
    torch.cuda.empty_cache()
    dist_phase(torch, launches, U_packed)
    pencil_phase(torch, launches, Uc, U_packed)
    del Uc, U_packed
    for k, n in launches.items():
        check(n > 0, f"main path launched {k} {n} times")

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "launches": launches[k], **kern[k]}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
