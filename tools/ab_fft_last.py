#!/usr/bin/env python3
"""A/B of the last-axis c2c kernel (``ops/csrc/fft_last.cu``, rows 10 and 20).

    python3 tools/ab_fft_last.py [--src DIR[:FLAGS] ...] [--iters 30]
                                 [--edit 'LABEL:REGEX=>REPL' ...] [--sweep]

For each ``--src`` directory (a copy of ``mpifft4py_tpu_torch/ops/csrc``;
default the package's own; after a colon, extra nvcc flags separated by
commas, e.g. ``csrc:-lineinfo``), builds two libraries from its
``fft_last.cu`` with one ``nvcc`` each, all started together, under
``build/ab_fft_last/``:

- ``full``: the source as it is;
- ``copy``: the same source with the ``fftblock::block_fft...`` call cut
  out, so the kernel only moves each tile in (global -> shared) and back
  out (shared -> global), with no FFT stages;
- one more library for each ``--edit`` of the last ``--src``: its
  ``fft_last.cu`` and ``fft_block.cuh`` with every match of REGEX replaced
  by REPL (several pairs separated by ``;;``), e.g. a kernel without its
  global stores, to see what each part of the kernel costs.

Then it times every library's kernel, in turns (forward order, then
backward), at the shapes the main path gives it: row 10 (planar float32
(65536, 256), the 256^3 C2C's z stage), row 10 at n = 384 (the 3/2 rule's
(147456, 384)) and row 20 (complex64 (65536, 129), the dense 256^3 chain's
last axis), beside one ``torch.fft.fft`` call on the same data.  Each time
is the median of ``--iters`` CUDA-event timings; the rate counts each input
byte read once and each output byte written once.  Each ``full`` library's
outputs are held against ``torch.fft`` (relative 1e-5).  ``--sweep`` first
holds the last ``--src``'s full library, both layouts, at every n in
2..1024 against ``torch.fft`` (1e-5) and in a round trip (1e-6), on
37 rows and on a view that starts one value into a larger buffer (a base
that is not 16-byte aligned).  Prints the card's
name and power limit, one line a (shape, variant), and writes the numbers
to ``chiprun_out/ab_fft_last.json``.  Needs a CUDA card and ``nvcc``.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mpifft4py_tpu_torch.ops import _build  # noqa: E402

OUT = ROOT / "build" / "ab_fft_last"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGS = {"fft_last_launch": (_P,) * 5 + (_L, _I, _I, ctypes.c_float, _P),
        "fft_last_c64_launch": (_P, _P, _P, _L, _I, _I, _P)}


def substitute(text, edit, name):
    for pair in edit.split(";;"):
        pat, _, repl = pair.partition("=>")
        text, hits = re.subn(pat, repl, text)
        print(f"edit {name}: {pat!r} -> {repl!r}: {hits} match(es)")
    return text


def build(srcs, edits=()):
    """{(label, variant): CDLL} for each source dir, full and copy-only,
    and each edit of the last one."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    jobs = []
    for i, spec in enumerate(srcs):
        src, _, extra = spec.partition(":")
        extra = [f for f in extra.split(",") if f]
        files = {f: (Path(src) / f).read_text()
                 for f in ("fft_last.cu", "fft_block.cuh")}
        # the block_fft... call: a statement, or the condition of the
        # store pass that runs when the last stage did not store
        copy, cut = re.subn(r"fftblock::block_fft\w*<[^;{]*\);", "",
                            files["fft_last.cu"])
        if not cut:
            copy, cut = re.subn(r"!fftblock::block_fft\w*<[^;{]*\)\)",
                                "true)", files["fft_last.cu"])
        if cut != 1:
            raise SystemExit(f"{src}/fft_last.cu: found {cut} block_fft "
                             f"calls, expected 1")
        variants = [("full", files),
                    ("copy", {**files, "fft_last.cu": copy})]
        if i == len(srcs) - 1:
            for edit in edits:
                name, _, rule = edit.partition(":")
                variants.append((name, {f: substitute(t, rule, name)
                                        for f, t in files.items()}))
        label = f"{i}:{Path(src).resolve().parents[2].name}" + "".join(extra)
        for variant, body in variants:
            d = OUT / f"{i}_{variant}"
            d.mkdir(exist_ok=True)
            for f, t in body.items():
                (d / f).write_text(t)
            so = d / "lib.so"
            cmd = [nvcc, *_build.FLAGS, *extra, "-shared", "-I", str(d),
                   "-o", str(so), str(d / "fft_last.cu")]
            jobs.append(((label, variant), so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    libs = {}
    for key, so, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        for line in log.splitlines():
            if re.search(r"registers|spill", line):
                print(f"ptxas {key[0]} {key[1]}: {line.strip()}")
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGS.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        libs[key] = lib
    return libs


def sweep(torch, lib, stream):
    """The library's kernel at every n in 2..1024, both layouts, aligned
    and one value into a larger buffer: forward against torch.fft (1e-5 of
    max |twin|), round trip (1e-6 of max |x|).  Returns the failures."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    bad, worst = [], [0.0, 0.0]
    rows = 37
    for n in range(2, 1025):
        tws = {}
        for inv in (0, 1):
            ang = (1 if inv else -1) * 2.0 * np.pi * np.arange(n) / n
            tws[inv] = torch.from_numpy(np.stack(
                [np.cos(ang), np.sin(ang)], -1).astype(np.float32)).cuda()
        for c64 in (False, True):
            for off in (0, 1):
                if c64:
                    buf = torch.complex(
                        *(torch.randn(rows * n + off, generator=gen,
                                      device="cuda") for _ in range(2)))
                    x = buf[off:].view(rows, n)

                    def run(a, inv):
                        y = torch.empty_like(a)
                        rc = lib.fft_last_c64_launch(
                            a.data_ptr(), y.data_ptr(), tws[inv].data_ptr(),
                            rows, n, inv, stream)
                        return rc, y
                else:
                    bufs = [torch.randn(rows * n + off, generator=gen,
                                        device="cuda") for _ in range(2)]
                    x = torch.complex(*(b[off:].view(rows, n)
                                        for b in bufs))
                    planes = [b[off:].view(rows, n) for b in bufs]

                    def run(a, inv, planes=None):
                        pr, pi = planes or (a.real.contiguous(),
                                            a.imag.contiguous())
                        yr, yi = torch.empty_like(pr), torch.empty_like(pi)
                        rc = lib.fft_last_launch(
                            pr.data_ptr(), pi.data_ptr(), yr.data_ptr(),
                            yi.data_ptr(), tws[inv].data_ptr(), rows, n,
                            inv, 1.0, stream)
                        return rc, torch.complex(yr, yi)
                    run = (lambda a, inv, run=run, planes=planes:
                           run(a, inv, planes if a is x else None))
                for inv in (0, 1):
                    rc, y = run(x, inv)
                    rc2, back = run(y, 1 - inv)
                    ref = (torch.fft.ifft if inv else torch.fft.fft)(
                        x, dim=-1)
                    torch.cuda.synchronize()
                    fwd = float((y - ref).abs().max() / ref.abs().max())
                    trip = float((back - x).abs().max() / x.abs().max())
                    worst = [max(worst[0], fwd), max(worst[1], trip)]
                    if rc or rc2 or not fwd <= 1e-5 or not trip <= 1e-6:
                        bad.append(f"n={n} c64={c64} off={off} inv={inv}: "
                                   f"rc {rc}/{rc2} fwd {fwd:.3e} round "
                                   f"trip {trip:.3e}")
    print(f"sweep: n in 2..1024, 2 layouts x 2 offsets x 2 directions; "
          f"worst fwd {worst[0]:.3e}, round trip {worst[1]:.3e}; "
          f"{len(bad)} failures")
    for b in bad[:20]:
        print(f"sweep FAIL {b}")
    return bad


def median_ms(torch, fn, iters, warmup=3):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", action="append",
                    help="a csrc directory (repeatable; default the "
                         "package's)")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--edit", action="append", default=[],
                    help="LABEL:REGEX=>REPL[;;REGEX=>REPL...], a variant "
                         "of the last --src")
    ap.add_argument("--sweep", action="store_true",
                    help="first check the last --src at every n")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    srcs = args.src or [str(_build.CSRC)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(f"card: {smi[0] if smi else 'nvidia-smi gave nothing'}")
    libs = build(srcs, args.edit)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.sweep and sweep(torch, libs[(list(libs)[-1][0], "full")],
                            stream):
        raise SystemExit("the sweep failed")

    def tw(n):
        ang = -2.0 * np.pi * np.arange(n) / n
        return torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)], -1)
                                .astype(np.float32)).to(dev)

    results = []
    for row, rows, n, c64 in (("row 10", 65536, 256, False),
                              ("row 10", 147456, 384, False),
                              ("row 20", 65536, 129, True)):
        t = tw(n)
        if c64:
            x = torch.complex(*(torch.randn((rows, n), generator=gen,
                                            device=dev) for _ in range(2)))
            y = torch.empty_like(x)
            nb = 2 * x.numel() * 8

            def call(lib, x=x, y=y, t=t, rows=rows, n=n):
                rc = lib.fft_last_c64_launch(x.data_ptr(), y.data_ptr(),
                                             t.data_ptr(), rows, n, 0,
                                             stream)
                if rc:
                    raise SystemExit(f"launch failed: CUDA error {rc}")

            def got(x=x, y=y):
                return y, torch.fft.fft(x, dim=-1)
            lib_fn = (lambda x=x: torch.fft.fft(x, dim=-1))
        else:
            xr, xi = (torch.randn((rows, n), generator=gen, device=dev)
                      for _ in range(2))
            yr, yi = torch.empty_like(xr), torch.empty_like(xi)
            z = torch.complex(xr, xi)
            nb = 4 * xr.numel() * 4

            def call(lib, xr=xr, xi=xi, yr=yr, yi=yi, t=t, rows=rows, n=n):
                rc = lib.fft_last_launch(xr.data_ptr(), xi.data_ptr(),
                                         yr.data_ptr(), yi.data_ptr(),
                                         t.data_ptr(), rows, n, 0, 1.0,
                                         stream)
                if rc:
                    raise SystemExit(f"launch failed: CUDA error {rc}")

            def got(yr=yr, yi=yi, z=z):
                return torch.complex(yr, yi), torch.fft.fft(z, dim=-1)
            lib_fn = (lambda z=z: torch.fft.fft(z, dim=-1))
        shape = f"{'complex64' if c64 else 'planar'} ({rows}, {n})"
        for key, lib in libs.items():
            if key[1] == "full":
                call(lib)
                a, b = got()
                torch.cuda.synchronize()
                err = float((a - b).abs().max() / b.abs().max())
                print(f"check {row} {shape} {key[0]} full: rel err "
                      f"{err:.3e}")
                if err > 1e-5:
                    raise SystemExit("the full kernel disagrees with "
                                     "torch.fft")
        order = list(libs.items())
        times = {k: [] for k in libs}
        lib_ms = [median_ms(torch, lib_fn, args.iters)]
        for key, lib in order + order[::-1]:
            times[key].append(median_ms(torch, lambda: call(lib),
                                        args.iters))
        lib_ms.append(median_ms(torch, lib_fn, args.iters))
        for key in libs:
            ms = times[key]
            print(f"time {row} {shape} {key[0]} {key[1]}: "
                  f"{ms[0]:.4f} / {ms[1]:.4f} ms, "
                  f"{nb / min(ms) / 1e9:.3f} TB/s")
            results.append(dict(row=row, shape=shape, src=key[0],
                                variant=key[1], ms=ms, bytes=nb))
        print(f"time {row} {shape} torch.fft: {lib_ms[0]:.4f} / "
              f"{lib_ms[1]:.4f} ms")
        results.append(dict(row=row, shape=shape, src="torch.fft",
                            variant="library", ms=lib_ms, bytes=nb))
    out = ROOT / "chiprun_out" / "ab_fft_last.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(dict(card=smi, results=results), indent=1))
    print(json.dumps(dict(card=smi[0] if smi else None, n=len(results))))


if __name__ == "__main__":
    main()
