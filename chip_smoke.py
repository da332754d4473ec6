#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mpifft4py_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each checked; any failed check makes the exit code non-zero:

0. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
1. build the CUDA kernels from ``mpifft4py_tpu_torch/ops/csrc`` (nvcc);
2. kernels: each hand-written kernel against its ``torch.fft`` twin on the
   card, at the shapes of the 256³ and 512³ transforms (relative 1e-5);
3. transforms: ``slab.R2C`` at 256³ and 512³ against float64
   ``torch.fft.rfftn``, the round trip, the 2/3-rule forward, and the
   round-trip time beside ``torch.fft``'s;
4. solver: ``NavierStokes3D`` RK4 at 256³ from Taylor–Green, 5 steps,
   against the same run in ``precision="double"``.

Phases 3 and 4 are the main path: the kernels' launch counters are zeroed
before them and read after.  The second-to-last line is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits 1 and prints no result.
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

KERNELS = {
    # name: (source, Pallas kernel it replaces)
    "fft_axis": ("mpifft4py_tpu_torch/ops/csrc/fft_axis.cu",
                 "mpifft4py_tpu/ops/pallas_fft3d.py:330"),
    "packed_rfft_last": ("mpifft4py_tpu_torch/ops/csrc/packed_rfft.cu",
                         "mpifft4py_tpu/ops/pallas_fft3d.py:636"),
    "packed_irfft_last": ("mpifft4py_tpu_torch/ops/csrc/packed_rfft.cu",
                          "mpifft4py_tpu/ops/pallas_fft3d.py:849"),
}

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

    # times at the 256^3 main-path shapes, kernel beside twin, in turns
    xr, xi, u = cu((256, 256, 128)), cu((256, 256, 128)), cu((256, 256, 256))
    cases = {
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
        print(f"time {name} 256^3 stage: kernel {k1:.4f} / {k2:.4f} ms, "
              f"torch.fft twin {p1:.4f} / {p2:.4f} ms", flush=True)
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
        for k in p3.LAUNCHES:
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


def solver_phase(torch, p3, R2C, NavierStokes3D):
    def make(precision):
        FFT = R2C(np.array([256] * 3), np.array([TAU] * 3), None, precision,
                  device="cuda")
        return NavierStokes3D(FFT, nu=0.000625, dt=0.01, dealias="2/3-rule",
                              integrator="RK4")

    s = make("single")
    before = dict(p3.LAUNCHES)
    U0 = s.taylor_green()
    e = [s.energy(U0)]
    check(abs(e[0] - 0.125) < 1e-6, f"NS3D 256^3 energy at t=0: {e[0]!r}")
    U = U0
    for _ in range(5):                        # energies after every step
        U = s.step(U)
        e.append(s.energy(U))
    print(f"NS3D 256^3 RK4 energies: {e}", flush=True)
    V = U0                                    # the same 5 steps, timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        V = s.step(V)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / 5
    del V
    check(all(np.isfinite(e)) and all(a > b for a, b in zip(e, e[1:])),
          "NS3D 256^3 energies finite and strictly decreasing over 5 steps")
    for k in p3.LAUNCHES:
        check(p3.LAUNCHES[k] > before[k],
              f"NS3D 256^3 launched {k}: {p3.LAUNCHES[k] - before[k]}")
    d = make("double")
    W = d.taylor_green()
    for _ in range(5):
        W = d.step(W)
    err = float(torch.linalg.vector_norm(U.to(torch.complex128) - W)
                / torch.linalg.vector_norm(W))
    check(err <= 1e-5, f"NS3D 256^3 single vs double after 5 steps: "
                       f"rel L2 err {err:.3e}")
    print(f"time NS3D 256^3 RK4 2/3-rule single: {ms_step:.3f} ms/step "
          f"(host clock over 5 steps, synchronised)", flush=True)
    return ms_step


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

    rng = np.random.default_rng(SEED)
    kern = kernel_phase(torch, p3, rng)

    p3.reset_launches()                       # the main path starts here
    transform_phase(torch, p3, R2C, rng)
    solver_phase(torch, p3, R2C, NavierStokes3D)
    launches = dict(p3.LAUNCHES)
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
