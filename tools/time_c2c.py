#!/usr/bin/env python3
"""Time ``slab.C2C``'s round trips at 256³ on the card, for one checkout.

    python3 tools/time_c2c.py [--root DIR] [--iters 20]

Imports ``mpifft4py_tpu_torch`` from ``--root`` (default: this checkout; a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists, e.g. ``build/parent``, times the parent's kernels),
builds its kernels into that root's ``build/torch_kernels``, and prints one
JSON line: the median CUDA-event ms of ``backward_fn()(forward_fn()(u))``
(the 256³ round trip: two ``fft_last`` launches at n = 256) and of
``forward_fn("3/2-rule")(backward_fn("3/2-rule")(fu))`` (the 3/2 rule: two
at n = 384 on the 384³ grid), each the smaller of two medians taken in
turns with ``torch.fft``'s ``ifftn(fftn(u))`` and ``fftn(ifftn(fu,
s=384³))``, and the card's name and power limit.  Run two roots in turns
(parent, this, this, parent) in one call to compare them on one card.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np


def median_ms(torch, fn, iters):
    for _ in range(3):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from mpifft4py_tpu_torch.ops import _build, fft3d as p3
    from mpifft4py_tpu_torch.slab import C2C
    _build.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    N = 256
    C = C2C(np.array((N,) * 3), np.array([2 * np.pi] * 3), None, "single",
            device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    u = torch.randn((N,) * 3, generator=g, device="cuda",
                    dtype=torch.complex64)
    fu = C.fftn(u)
    M = (384,) * 3
    out = {"root": args.root, "card": smi[0] if smi else None}
    for label, kern, lib in (
            ("C2C 256^3 round trip",
             lambda f=C.forward_fn(), b=C.backward_fn(): b(f(u)),
             lambda: torch.fft.ifftn(torch.fft.fftn(u))),
            ("C2C 256^3 3/2-rule round trip",
             lambda f=C.forward_fn("3/2-rule"),
             b=C.backward_fn("3/2-rule"): f(b(fu)),
             lambda: torch.fft.fftn(torch.fft.ifftn(fu, s=M)))):
        before = p3.LAUNCHES["fft_last"]
        kern()
        launches = p3.LAUNCHES["fft_last"] - before
        k1, l1 = median_ms(torch, kern, args.iters), median_ms(
            torch, lib, args.iters)
        l2, k2 = median_ms(torch, lib, args.iters), median_ms(
            torch, kern, args.iters)
        out[label] = {"ms": min(k1, k2), "ms_pair": [k1, k2],
                      "torch_fft_ms": min(l1, l2),
                      "fft_last_launches": launches}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
