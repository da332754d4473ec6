#!/usr/bin/env python3
"""Time and profile the PyTorch/CUDA port's RK4 steps on one NVIDIA GPU,
their configurations side by side: NS3D's ``complex`` and ``packed`` (the
2/3 rule in each spectral layout) and ``padded`` (the complex layout with
the 3/2 rule), and the packed steps of the solver family, ``vv``, ``mhd``
and ``boussinesq`` (2/3 rule).

    python3 profile_step.py [--n 256] [--steps 5] [--configs packed,vv]

1. CUDA-event ms per step, ``--steps`` steps a sample, the configurations
   in turns (in order, reversed, in order again) after one warm-up step
   each;
2. ``torch.profiler`` over 3 steps of each configuration: the kernel count, the
   device busy time (union of the kernels' intervals), the idle share of
   the span from the first kernel's start to the last one's end, and the
   busy time per kernel group (each hand-written kernel, ``cat``,
   reductions, copies, other elementwise), then the largest other kernels.

The Chrome traces go to ``build/profile_step/trace_<config>.json``.
Prints the card's name and power limit first; needs a CUDA device.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = {  # name: (model, spectral_layout, dealias, initial state)
    "complex": ("NavierStokes3D", "complex", "2/3-rule", "taylor_green"),
    "packed": ("NavierStokes3D", "packed", "2/3-rule", "taylor_green"),
    "padded": ("NavierStokes3D", "complex", "3/2-rule", "taylor_green"),
    "vv": ("VorticityVelocity3D", "packed", "2/3-rule", "taylor_green"),
    "mhd": ("MHD3D", "packed", "2/3-rule", "taylor_green_mhd"),
    "boussinesq": ("Boussinesq3D", "packed", "2/3-rule",
                   "taylor_green_stratified"),
}
NU = 0.000625
EXTRA = {"MHD3D": {"eta": NU}, "Boussinesq3D": {"kappa": NU}}
HAND_WRITTEN = ("curl_ifft_x_kernel", "product_rfft_z_kernel",
                "fft_x_epilogue_kernel", "packed_irfft_kernel",
                "packed_rfft_kernel", "fft_axis_kernel",
                "planar_rfft_kernel", "planar_irfft_kernel", "fft_last_kernel")


def group(name):
    """A kernel's group: each hand-written kernel (a template variant with
    its arguments, e.g. ``fft_x_epilogue_kernel<1, false>``), ``cat``,
    reductions, copies, or other elementwise work."""
    for key in HAND_WRITTEN:
        if key in name:
            m = re.search(re.escape(key) + r"(<[^>]*>)?", name)
            return m.group(0)
    low = name.lower()
    if "cat" in low:
        return "cat"
    if "reduce" in low:
        return "reduce"
    if "copy" in low:
        return "copy"
    return "elementwise/other"


def busy_us(kernels):
    """Length of the union of the kernels' [ts, ts + dur) intervals."""
    busy, cur = 0.0, None
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return busy + (cur[1] - cur[0] if cur else 0.0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=256, help="grid size n³")
    ap.add_argument("--steps", type=int, default=5,
                    help="steps per timed sample")
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="comma-separated configurations, of "
                         + ", ".join(CONFIGS))
    args = ap.parse_args()
    configs = args.configs.split(",")
    if not set(configs) <= set(CONFIGS):
        ap.error(f"--configs: unknown {sorted(set(configs) - set(CONFIGS))}")
    order = (*configs, *reversed(configs), *configs)

    import torch
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from torch.profiler import ProfilerActivity, profile
    from mpifft4py_tpu_torch import models
    from mpifft4py_tpu_torch.slab import R2C

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    FFT = R2C(np.array([args.n] * 3), np.array([2 * np.pi] * 3), None,
              "single", device="cuda")
    sol, state = {}, {}
    for c in configs:
        model, layout, dealias, init = CONFIGS[c]
        sol[c] = getattr(models, model)(FFT, nu=NU, dt=0.01,
                                        spectral_layout=layout,
                                        dealias=dealias,
                                        **EXTRA.get(model, {}))
        state[c] = sol[c].step(getattr(sol[c], init)())
    torch.cuda.synchronize()

    def event_ms(c):
        s, U = sol[c], state[c]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.steps):
            U = s.step(U)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / args.steps

    res = {c: [] for c in configs}
    for c in order:
        res[c].append(event_ms(c))
    print(f"{args.n}^3 RK4 event ms/step ({args.steps} steps a sample, "
          f"in turns {' '.join(order)}): {json.dumps(res)}",
          flush=True)

    out = os.path.join(HERE, "build", "profile_step")
    os.makedirs(out, exist_ok=True)
    for c in configs:
        s, U = sol[c], state[c]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                U = s.step(U)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        path = os.path.join(out, f"trace_{c}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            ks = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel"]
        busy = busy_us(ks)
        span = max(e["ts"] + e["dur"] for e in ks) - min(e["ts"] for e in ks)
        print(f"PROFILE {c}: 3 steps, host wall {wall:.3f} ms, kernels "
              f"{len(ks)}, device busy {busy / 1e3:.3f} ms over a span of "
              f"{span / 1e3:.3f} ms, idle share of the span "
              f"{1 - busy / span:.4f}", flush=True)
        groups, other = {}, {}
        for e in ks:
            g = group(e["name"])
            n, d = groups.get(g, (0, 0.0))
            groups[g] = (n + 1, d + e["dur"])
            if g == "elementwise/other":
                n, d = other.get(e["name"][:90], (0, 0.0))
                other[e["name"][:90]] = (n + 1, d + e["dur"])
        for g, (n, d) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
            print(f"   {g:28s} n={n:5d} {d / 1e3:9.3f} ms "
                  f"({d / busy:.3f} of busy)")
        for nm, (n, d) in sorted(other.items(), key=lambda kv: -kv[1][1])[:8]:
            print(f"      {nm:90s} n={n:4d} {d / 1e3:8.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
