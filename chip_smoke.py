#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mpifft4py_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each checked; any failed check makes the exit code non-zero:

0. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
1. build the CUDA kernels from ``mpifft4py_tpu_torch/ops/csrc`` (nvcc);
2. kernels: each hand-written kernel against its plain twin on the card,
   at the shapes of the 256³ and 512³ transforms and of the 256³ packed
   NS3D step, the cross kernel also at a 512-class plane (relative 1e-5),
   with each kernel's time beside its twin's;
3. transforms: ``slab.R2C`` at 256³ and 512³ against float64
   ``torch.fft.rfftn``, the round trip, the 2/3-rule forward, and the
   round-trip time beside ``torch.fft``'s;
4. solver: ``NavierStokes3D`` RK4 at 256³ from Taylor–Green, 5 steps,
   against the same run in ``precision="double"``;
5. packed solver: the same 5 steps with ``spectral_layout="packed"``,
   against the complex-layout float32 and float64 runs, with its ms per
   step and peak memory beside the complex layout's.

Phases 3–5 are the main path: each runs with the kernels' launch counters
set to 0 just before it and read just after, and phases 4–5 also read them
around each of their steps.  The second-to-last line is ``{"kernels": [...]}``; the last is
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
    "cross_rfft_z": (f"{CSRC}/cross_rfft_z.cu",
                     f"{PALLAS}:1805 (row 12); {PALLAS}:1755 (row 13)"),
    "fft_x_epilogue": (f"{CSRC}/fft_x_epilogue.cu",
                       f"{PALLAS}:1981 (row 14)"),
}
NU, DT = 0.000625, 0.01
TRANSFORM_KERNELS = ("fft_axis", "packed_rfft_last", "packed_irfft_last")
PACKED_STEP_KERNELS = ("curl_ifft_x", "cross_rfft_z", "fft_x_epilogue",
                       "fft_axis", "packed_irfft_last")

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


def packed_vectors(n):
    """The packed NS3D step's 1-D wavenumbers and 2/3-rule masks at n³
    (L = 2π): k0, k1, k2, m0, m1, m2 on the card."""
    from mpifft4py_tpu_torch.utils import spectral
    N = (n, n, n)
    return (spectral.factored_wavenumbers(N, None, n // 2, device="cuda")
            + spectral.packed_dealias_masks(N, "cuda"))


def kernel_phase(torch, p3, rng):
    """Each kernel against its twin; returns {name: (max_abs_err, ms, plain_ms)}."""
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
    epi_ref = (lambda: p3.fft_x_epilogue_packed_ref(ur, ui, sr, si, *km, NU))
    compare("fft_x_epilogue", "256^3 project", tuple(epi()), tuple(epi_ref()))

    # times at the 256^3 main-path shapes, kernel beside twin, in turns
    xr, xi, u = cu((256, 256, 128)), cu((256, 256, 128)), cu((256, 256, 256))
    cases = {
        "curl_ifft_x": (lambda: p3.curl_ifft_x(ur, ui, *km[:3], True),
                        lambda: p3.curl_ifft_x_ref(ur, ui, *km[:3], True)),
        "cross_rfft_z": (lambda: p3.cross_rfft_z(a, b),
                         lambda: p3.cross_rfft_z_ref(a, b)),
        "fft_x_epilogue": (epi, epi_ref),
        "fft_axis": (lambda: p3.fft_axis_planar(xr, xi, 0),
                     lambda: p3.fft_axis_planar_ref(xr, xi, 0)),
        "packed_rfft_last": (lambda: p3.rfft_last_packed(u),
                             lambda: p3.rfft_last_packed_ref(u)),
        "packed_irfft_last": (lambda: p3.irfft_last_packed(xr, xi, 256),
                              lambda: p3.irfft_last_packed_ref(xr, xi, 256)),
    }
    out = {}
    for name, (kern, plain) in cases.items():
        p1, k1 = median_ms(torch, plain), median_ms(torch, kern)
        k2, p2 = median_ms(torch, kern), median_ms(torch, plain)
        out[name] = (errs[name], min(k1, k2), min(p1, p2))
        print(f"time {name} 256^3: kernel {k1:.4f} / {k2:.4f} ms, "
              f"plain twin {p1:.4f} / {p2:.4f} ms", flush=True)
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


def make_solver(R2C, NavierStokes3D, precision, layout="complex"):
    FFT = R2C(np.array([256] * 3), np.array([TAU] * 3), None, precision,
              device="cuda")
    return NavierStokes3D(FFT, nu=NU, dt=DT, dealias="2/3-rule",
                          integrator="RK4", spectral_layout=layout)


def run_steps(torch, p3, s, label):
    """5 RK4 steps from Taylor–Green with the energy after each, then the
    same 5 steps timed (host clock, synchronised) with the peak device
    memory above what was resident before them.  Returns the state, the
    energies, ms per step, the peak bytes and the launches of the steps."""
    U0 = s.taylor_green()
    e = [s.energy(U0)]
    check(abs(e[0] - 0.125) < 1e-6, f"{label} energy at t=0: {e[0]!r}")
    steps = dict.fromkeys(p3.LAUNCHES, 0)
    U = U0
    for _ in range(5):
        before = dict(p3.LAUNCHES)
        U = s.step(U)
        for k in steps:
            steps[k] += p3.LAUNCHES[k] - before[k]
        e.append(s.energy(U))
    print(f"{label} RK4 energies: {e}", flush=True)
    check(all(np.isfinite(e)) and all(a > b for a, b in zip(e, e[1:])),
          f"{label} energies finite and strictly decreasing over 5 steps")
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from mpifft4py_tpu_torch.ops import _build, fft3d as p3
    from mpifft4py_tpu_torch.slab import R2C
    from mpifft4py_tpu_torch.models.navier_stokes import NavierStokes3D

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
    Uc, Ud, ms_c, peak_c = path(solver_phase, torch, p3, R2C, NavierStokes3D)
    path(packed_solver_phase, torch, p3, R2C, NavierStokes3D, Uc, Ud, ms_c,
         peak_c)
    for k, n in launches.items():
        check(n > 0, f"main path launched {k} {n} times")

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "launches": launches[k],
         "max_abs_err": kern[k][0], "ms": kern[k][1], "plain_ms": kern[k][2]}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
