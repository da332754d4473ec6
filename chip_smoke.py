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
   (relative 1e-5), with each kernel's time beside its twin's;
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
   against 4 × the count of one right-hand side.

Phase 3 also runs the 3/2-rule transforms at 256³ (the padded round trip,
the forward of a product field against a float64 alias-sum oracle) and
``slab.C2C`` (forward against float64 ``torch.fft.fftn``, round trip, and
the 3/2-rule round trip and forward, the latter against float64 ``fftn``
on the 384³ grid truncated to 256³).
Phases 3–7 are the main path: each runs with the kernels' launch counters
set to 0 just before it and read just after, and phases 4–7 also read them
around each of their steps.  Phase 2 also holds each template variant of
the fused kernels (Biot–Savart curl, cross2 and mul products, the curl,
div and buoyancy epilogues) against its twin at the 256³ shapes of the
solvers' right-hand sides.  Each kernel's time is its median beside its
plain twin's and, where one exists, one ``torch.fft`` call's computing the
same function, with the bound of its bytes at 3.35 TB/s and of its FFT
flops (5 n log2 n a complex transform, half that a real one) at 67 TFLOP/s
FP32.  The second-to-last line is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TAU = 2 * np.pi
SEED = 0

PALLAS = "mpifft4py_tpu/ops/pallas_fft3d.py"
CSRC = "mpifft4py_tpu_torch/ops/csrc"
KERNELS = {
    # name: (source, Pallas kernel(s) it replaces, with their row in PERF.md)
    "fft_axis": (f"{CSRC}/fft_axis.cu", f"{PALLAS}:330 (row 1)"),
    "packed_rfft_last": (f"{CSRC}/packed_rfft.cu", f"{PALLAS}:636 (row 4)"),
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
}
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


def kernel_phase(torch, p3, rng):
    """Each kernel against its twin; returns {name: its JSON numbers}."""
    def cu(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).cuda()

    errs = {k: 0.0 for k in KERNELS}

    def compare(name, label, got, ref):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            rel = rel_err(torch, g, r)
            errs[name] = max(errs[name], float((g - r).abs().max()))
            check(rel <= 1e-5, f"kernel {name} {label}: rel err {rel:.3e} "
                               f"(max |twin| {float(r.abs().max()):.4e})")

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

    # times at the main path's shapes: kernel, twin and the one torch.fft
    # call computing the same function (None for the fused kernels), in
    # turns, with the bound of the call's bytes and flops
    xr, xi = cu((256, 256, 128)), cu((256, 256, 128))
    z, zc = torch.complex(xr, xi), torch.complex(cr, ci)
    zh = torch.complex(cu((256, 256, 129)), cu((256, 256, 129)))
    ph = torch.complex(pr, pi)
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
    return out


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
    err = rel_err(torch, C.fftn(C.ifftn(fu, dealias="3/2-rule"),
                                dealias="3/2-rule"), fu)
    check(err < 1e-6, f"C2C 256^3 3/2-rule round trip: rel err {err:.3e}")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    w = torch.randn((384,) * 3, generator=g, device="cuda",
                    dtype=torch.complex64)
    ref = fold_full_axes(torch, torch.fft.fftn(w.to(torch.complex128))
                         / C.padsize ** 3, N, (0, 1, 2))
    err = rel_err(torch, C.fftn(w, dealias="3/2-rule"), ref)
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from mpifft4py_tpu_torch.ops import _build, fft3d as p3
    from mpifft4py_tpu_torch.slab import C2C, R2C
    from mpifft4py_tpu_torch.models import (Boussinesq3D, MHD3D,
                                            NavierStokes3D,
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
    kern = kernel_phase(torch, p3, rng)

    # the main path: each of its paths runs with the counts set to 0 just
    # before it and read just after
    launches = dict.fromkeys(p3.LAUNCHES, 0)

    def path(phase, *args):
        p3.reset_launches()
        out = phase(*args)
        for k, n in p3.LAUNCHES.items():
            launches[k] += n
        return out

    path(transform_phase, torch, p3, R2C, rng)
    path(padded_transform_phase, torch, p3, R2C, C2C, rng)
    Uc, Ud, ms_c, peak_c = path(solver_phase, torch, p3, R2C, NavierStokes3D)
    path(packed_solver_phase, torch, p3, R2C, NavierStokes3D, Uc, Ud, ms_c,
         peak_c)
    path(padded_solver_phase, torch, p3, R2C, NavierStokes3D, ms_c, peak_c)
    path(family_phase, torch, p3, {"R2C": R2C, "VV": VorticityVelocity3D,
                                   "MHD": MHD3D, "Boussinesq": Boussinesq3D},
         Uc, Ud)
    del Uc, Ud
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
