#!/usr/bin/env python3
"""A/B of the persistent FFT kernels: the last-axis c2c (``ops/csrc/
fft_last.cu``, rows 10 and 20), the even-n r2c (``ops/csrc/
planar_rfft.cu``'s ``planar_rfft_kernel``, rows 8 and 21), the packed
r2c (rows 4 and 17: ``packed_rfft_launch``/``packed_rfft_zdif_launch``,
wherever the source tree defines them) and the c2c along a non-last axis
(``ops/csrc/fft_axis.cu``, rows 1 and 19); and of the complex layout's
pointwise right-hand side (``ops/csrc/rhs_pointwise.cu``, port-only rows
P1-P3) against its eager twins.

    python3 tools/ab_fft_last.py [--kernel fft_last|planar_rfft|packed_rfft|
                                  fft_axis|rhs_pointwise]
                                 [--src DIR[:FLAGS] ...] [--iters 30]
                                 [--edit 'LABEL:REGEX=>REPL' ...] [--sweep]

For each ``--src`` directory (a copy of ``mpifft4py_tpu_torch/ops/csrc``;
default the package's own; after a colon, extra nvcc flags separated by
commas, e.g. ``csrc:-lineinfo``), builds libraries from the kernel's
sources (``fft_last.cu``, ``planar_rfft.cu``, ``fft_axis.cu``,
``rhs_pointwise.cu``, or ``packed_rfft.cu`` and ``planar_rfft.cu``
together, with every ``*.cuh`` of
the directory beside them) with one ``nvcc`` each, all started together, under
``build/ab_<kernel>/``:

- ``full``: the sources as they are;
- ``copy``: the same sources with the kernel's ``fftblock::block_fft...``
  call cut out (and, for the r2c kernels, its untangle replaced by the
  spectrum's own values), so the kernel only moves each tile in (global ->
  shared) and back out (shared -> global), with no FFT stages (not for
  ``rhs_pointwise``, which only streams);
- ``nount`` (``packed_rfft`` only): the untangle cut, the stages kept;
- one more library for each ``--edit`` of the last ``--src``: its source
  and headers with every match of REGEX replaced by REPL (several pairs
  separated by ``;;``), e.g. a kernel without its global stores, to see
  what each part of the kernel costs.

Then it times every library's kernel, in turns (forward order, then
backward), at the shapes the main path gives it, beside one ``torch.fft``
call on the same data:

- ``fft_last``: row 10 (planar float32 (65536, 256), the 256^3 C2C's z
  stage), row 10 at n = 384 (the 3/2 rule's (147456, 384)) and row 20
  (complex64 (65536, 129), the dense 256^3 chain's last axis);
- ``planar_rfft``: row 21 (float32 (65536, 256) -> complex64 (65536, 129),
  the dense 256^3 chain's r2c), row 8 (float32 (442368, 384) -> planar
  (442368, 129), nf = 129 with the column doubled and scale 1/1.5^3, the
  3/2 rule's z stage) and the 2x2 pencil's z stage (float32 (16384, 256)
  -> planar (16384, 130), zeros in column 129);
- ``packed_rfft``: row 4 (float32 (65536, 256) -> packed planar (65536,
  128), the 256^3 transform's z stage), row 17 (float32 (1024, 1024)
  -> packed planar (1024, 512) in DIF lane order, NS2D 1024^2's field)
  and row 4 at n = 640 ((409600, 640), ``serialFFT`` 640^3's z stage, a
  mixed-radix plan);
- ``fft_axis``: row 1 (planar float32 (256, 256, 128) along axis 0, the
  256^3 transform's x stage), the y stage (axis 1 of the same) and the
  packed step's 3-stack ((3, 256, 256, 128), axis 2), the 3/2 rule's n =
  384 ((384, 384, 384), axes 0 and 1) and the 3/2 rule's y stage ((3,
  384, 384, 129), axis 2: 516-byte rows), row 19 (complex64 (256, 256, 129)
  along axis 1, the dense 256^3 chain's y stage), NS2D 1024^2's x stage
  ((1024, 512), axis 0) and the widened plans n = 640 and 1016 on (n,
  32768), axis 0;
- ``rhs_pointwise``: at the 512^3 cells' shapes, beside the eager twin
  (``ops.fft3d.rhs_*_ref``, the expressions ``NavierStokes3D.rhs`` ran
  before the kernels) in place of ``torch.fft``: the curl i K x U and the
  projection with the viscous term on (3, 512, 512, 257) complex64
  stacks, U x w on (3, n^3) float32 stacks at n = 512 (the 2/3 rule's N
  grid) and 768 (the 3/2 rule's M grid).

Each time is the median of ``--iters`` CUDA-event timings; the rate counts
each input byte read once and each output byte written once, beside its
share of the H100's 3.35 TB/s.  Each ``full`` library's outputs are held
against ``torch.fft`` or the twin (relative 1e-5).
``--sweep`` first holds the last ``--src``'s full library, both layouts,
against ``torch.fft`` (1e-5) and in a round trip (1e-6), on 37 rows and on
views that start one value into a larger buffer (bases off the bulk
copies' 16-byte grid): ``fft_last`` at every n in 2..1024; ``planar_rfft``
at every even n in 4..2048, the planar layout also with nf < n/2 + 1 (the
column nf - 1 doubled, scaled) into a width > nf (its round trip through
the same library's c2r where nf = n/2 + 1); ``packed_rfft`` at every even
n in 4..2048 in natural order and at n = 512, 768, 1024 in DIF order,
input and spectrum aligned and one value in, round trips through the
library's packed c2r; ``fft_axis`` at every ``supported_c2c`` n in 2..1024
on (pre, n, post) with pre in {1, 3} and post in {1, 5, 129, 4096}, input
and output aligned and 1-3 values into larger buffers (separate offsets
for the two); ``rhs_pointwise`` has no sweep.  Prints the card's name and
power limit, one line a (shape, variant), and writes the numbers to
``chiprun_out/ab_<kernel>.json``.  Needs a CUDA card and ``nvcc``.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mpifft4py_tpu_torch.ops import _build  # noqa: E402

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# the r2c kernels' copy-only cuts: the block_fft... call (the first after
# the kernel's name), and the untangle (one spectral value a column, or the
# pair)
STAGES_R2C = [(r"(packed_rfft_kernel\(.*?)fftblock::block_fft\w*<[^;{]*\);",
               r"\1"),
              (r"(planar_rfft_kernel\(.*?)fftblock::block_fft\w*<[^;{]*\);",
               r"\1")]
UNTANGLE_R2C = [(r"packedz::untangle\(s, pitch, rho, k, h, tw_n\)",
                 "s[k * pitch + rho]"),
                (r"untangle_pair\(Z, Zf, [^;]*\);", "Xk = Z; Xf = Zf;")]
_PACKED = (_P,) * 5 + (_L, _I, _P)
HBM = 3.35e12                 # H100 SXM HBM3, bytes/s
NU = 0.000625                 # the 512^3 cells' viscosity
# kernel: its sources, its entry points' argtypes, and its variants beside
# `full`: groups of (REGEX, REPL) alternatives, the first alternative that
# matches in the sources applied, each group matching exactly once
KERNELS = {
    "fft_last": dict(
        sources=("fft_last.cu",),
        sigs={"fft_last_launch": (_P,) * 5 + (_L, _I, _I, _F, _P),
              "fft_last_c64_launch": (_P, _P, _P, _L, _I, _I, _P)},
        # the block_fft... call: a statement, or the condition of the store
        # pass that runs when the last stage did not store
        variants={"copy": [[(r"fftblock::block_fft\w*<[^;{]*\);", ""),
                            (r"!fftblock::block_fft\w*<[^;{]*\)\)",
                             "true)")]]}),
    "planar_rfft": dict(
        sources=("planar_rfft.cu",),
        sigs={"planar_rfft_launch": (_P,) * 5 + (_L, _I, _I, _I, _I, _F, _P),
              "planar_irfft_launch": (_P,) * 5 + (_L, _I, _I, _I, _F, _P),
              "rfft_c64_launch": (_P,) * 4 + (_L, _I, _P),
              "irfft_c64_launch": (_P,) * 4 + (_L, _I, _P)},
        variants={"copy": [STAGES_R2C[1:], UNTANGLE_R2C]}),
    "packed_rfft": dict(
        sources=("packed_rfft.cu", "planar_rfft.cu"),
        sigs={"packed_rfft_launch": _PACKED,
              "packed_irfft_launch": _PACKED,
              "packed_rfft_zdif_launch": _PACKED,
              "packed_irfft_zdif_launch": _PACKED},
        variants={"copy": [STAGES_R2C, UNTANGLE_R2C],
                  "nount": [UNTANGLE_R2C]}),
    "fft_axis": dict(
        sources=("fft_axis.cu",),
        sigs={"fft_axis_launch": (_P,) * 5 + (_L, _I, _L, _I, _P),
              "fft_axis_c64_launch": (_P, _P, _P, _L, _I, _L, _I, _P)},
        variants={"copy": [[(r"fftblock::block_fft\w*<[^;{]*\);", ""),
                            (r"!fftblock::block_fft\w*<[^;{]*\)\)",
                             "true)")]]}),
    "rhs_pointwise": dict(
        sources=("rhs_pointwise.cu",),
        sigs={name: _build._SIGNATURES[name]
              for name in ("rhs_curl_launch", "rhs_cross_launch",
                           "rhs_leray_visc_launch")},
        variants={}, plain="twin"),
}


def substitute(text, edit, name):
    for pair in edit.split(";;"):
        pat, _, repl = pair.partition("=>")
        text, hits = re.subn(pat, repl, text)
        print(f"edit {name}: {pat!r} -> {repl!r}: {hits} match(es)")
    return text


def cut(src, files, groups):
    """``files`` ({name: text}) with each group of (REGEX, REPL)
    alternatives applied: the first alternative that matches, which must
    match exactly once in all of them."""
    files = dict(files)
    for group in groups:
        for pat, repl in group:
            hits = {f: len(re.findall(pat, t, flags=re.S))
                    for f, t in files.items()}
            if sum(hits.values()):
                break
        if sum(hits.values()) != 1:
            raise SystemExit(f"{src}: the cut {group[0][0]!r} matched "
                             f"{sum(hits.values())} times, expected 1")
        f = next(f for f, n in hits.items() if n)
        files[f] = re.sub(pat, repl, files[f], flags=re.S)
    return files


def build(kernel, srcs, edits=()):
    """{(label, variant): CDLL} for each source dir, full and copy-only,
    and each edit of the last one."""
    out = ROOT / "build" / f"ab_{kernel}"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    mains = KERNELS[kernel]["sources"]
    jobs = []
    for i, spec in enumerate(srcs):
        src, _, extra = spec.partition(":")
        extra = [f for f in extra.split(",") if f]
        files = {p.name: p.read_text()
                 for p in [*(Path(src) / m for m in mains),
                           *sorted(Path(src).glob("*.cuh"))]}
        variants = [("full", files)] + [
            (name, cut(src, files, groups))
            for name, groups in KERNELS[kernel]["variants"].items()]
        if i == len(srcs) - 1:
            for edit in edits:
                name, _, rule = edit.partition(":")
                variants.append((name, {f: substitute(t, rule, name)
                                        for f, t in files.items()}))
        label = f"{i}:{Path(src).resolve().parents[2].name}" + "".join(extra)
        for variant, body in variants:
            d = out / f"{i}_{variant}"
            d.mkdir(exist_ok=True)
            for f, t in body.items():
                (d / f).write_text(t)
            so = d / "lib.so"
            cmd = [nvcc, *_build.FLAGS, *extra, "-shared", "-I", str(d),
                   "-o", str(so), *(str(d / m) for m in mains)]
            jobs.append(((label, variant), so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    libs = {}
    for key, so, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        print_ptxas(key, log)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in KERNELS[kernel]["sigs"].items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        libs[key] = lib
    return libs


def print_ptxas(key, log):
    """One line a kernel instance: ptxas's registers and spill bytes (an
    instance's template arguments as numbers: a bool, an int, or an enum's
    value)."""
    name, spill = "?", ""
    for line in log.splitlines():
        m = re.search(r"entry function .*?\d([a-z][a-z_]*_kernel)I"
                      r"((?:L(?:b|i|N[^E]*E)\d+E)+)", line)
        if m:
            name = m.group(1) + "<" + ", ".join(
                re.findall(r"L(?:b|i|N[^E]*E)(\d+)E", m.group(2))) + ">"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f", spill stores/loads {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            print(f"ptxas {key[0]} {key[1]} {name}: {m.group(1)} "
                  f"registers{spill}")
            name, spill = "?", ""


def twiddles(torch, m, count, sign):
    """(count, 2) float32 exp(sign 2 pi i j/m), computed in float64."""
    ang = sign * 2.0 * np.pi * np.arange(count) / m
    return torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)], -1)
                            .astype(np.float32)).cuda()


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def sweep_fft_last(torch, lib, stream):
    """The c2c at every n in 2..1024, both layouts, aligned and one value
    into a larger buffer: forward against torch.fft (1e-5 of max |twin|),
    round trip (1e-6 of max |x|).  Returns the failures."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    bad, worst = [], [0.0, 0.0]
    rows = 37
    for n in range(2, 1025):
        tws = {inv: twiddles(torch, n, n, 1 if inv else -1)
               for inv in (0, 1)}
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
                    fwd, trip = rel(y, ref), rel(back, x)
                    worst = [max(worst[0], fwd), max(worst[1], trip)]
                    if rc or rc2 or not fwd <= 1e-5 or not trip <= 1e-6:
                        bad.append(f"n={n} c64={c64} off={off} inv={inv}: "
                                   f"rc {rc}/{rc2} fwd {fwd:.3e} round "
                                   f"trip {trip:.3e}")
    print(f"sweep: n in 2..1024, 2 layouts x 2 offsets x 2 directions; "
          f"worst fwd {worst[0]:.3e}, round trip {worst[1]:.3e}; "
          f"{len(bad)} failures")
    return bad


def rfft_ref(torch, x, nf, ld, dbl, scale):
    """numpy's rfft of the rows, the first nf columns, column nf - 1
    doubled if dbl, times scale, zeros up to ld (complex)."""
    X = torch.fft.rfft(x.double(), dim=-1)[..., :nf].clone()
    if dbl:
        X[..., -1] *= 2
    X = X * scale
    return torch.nn.functional.pad(X, (0, ld - nf)).to(torch.complex64)


def sweep_planar_rfft(torch, lib, stream):
    """The r2c at every even n in 4..2048: complex64 (nf = n/2 + 1) and
    planar, the planar with nf = n/2 + 1 into width nf and with nf about
    n/4 (doubled, scale 0.5) into width nf + 3; inputs and spectra aligned
    and one value into larger buffers; forward against float64 rfft (1e-5
    of max |X|), round trip through the library's c2r where nf = n/2 + 1
    (1e-6 of max |x|; the c2r stores float2 pairs, so its real rows stay
    aligned).  Returns the failures."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    bad, worst = [], [0.0, 0.0]
    rows = 37

    def view(count, off, dtype=torch.float32):
        buf = torch.empty(count + off, dtype=dtype, device="cuda")
        return buf[off:]

    for n in range(4, 2049, 2):
        if n % 256 == 0:
            print(f"sweep: n = {n}, {len(bad)} failures so far", flush=True)
        h = n // 2
        twf = (twiddles(torch, h, h, -1), twiddles(torch, n, h, -1))
        twb = (twiddles(torch, h, h, 1), twiddles(torch, n, h, 1))
        for off in (0, 1):
            x = view(rows * n, off)
            x.copy_(torch.randn(rows * n, generator=gen, device="cuda"))
            x = x.view(rows, n)
            cases = [("c64", h + 1, h + 1, 0, 1.0),
                     ("planar", h + 1, h + 1, 0, 1.0),
                     ("planar", max(2, h // 2), max(2, h // 2) + 3, 1, 0.5)]
            for layout, nf, ld, dbl, scale in cases:
                # the c2r stores float2 pairs: its output stays aligned
                back = view(rows * n, 0).view(rows, n)
                if layout == "c64":
                    y = view(rows * ld, off, torch.complex64).view(rows, ld)
                    rc = lib.rfft_c64_launch(
                        x.data_ptr(), y.data_ptr(), twf[0].data_ptr(),
                        twf[1].data_ptr(), rows, n, stream)
                    rc2 = lib.irfft_c64_launch(
                        y.data_ptr(), back.data_ptr(), twb[0].data_ptr(),
                        twb[1].data_ptr(), rows, n, stream)
                else:
                    yr = view(rows * ld, off).view(rows, ld)
                    yi = view(rows * ld, off).view(rows, ld)
                    rc = lib.planar_rfft_launch(
                        x.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                        twf[0].data_ptr(), twf[1].data_ptr(), rows, n, nf,
                        ld, dbl, scale, stream)
                    rc2 = lib.planar_irfft_launch(
                        yr.data_ptr(), yi.data_ptr(), back.data_ptr(),
                        twb[0].data_ptr(), twb[1].data_ptr(), rows, n, nf,
                        ld, 1.0, stream)
                    y = torch.complex(yr, yi)
                ref = rfft_ref(torch, x, nf, ld, dbl, scale)
                torch.cuda.synchronize()
                fwd = rel(y, ref)
                trip = rel(back, x) if nf == h + 1 else 0.0
                worst = [max(worst[0], fwd), max(worst[1], trip)]
                if rc or rc2 or not fwd <= 1e-5 or not trip <= 1e-6:
                    bad.append(f"n={n} {layout} nf={nf} ld={ld} off={off}: "
                               f"rc {rc}/{rc2} fwd {fwd:.3e} round trip "
                               f"{trip:.3e}")
    print(f"sweep: even n in 4..2048, c64 + planar (nf full and nf < "
          f"full, width > nf) x 2 offsets; worst fwd {worst[0]:.3e}, "
          f"round trip {worst[1]:.3e}; {len(bad)} failures")
    return bad


def packed_ref(torch, x, perm=None):
    """numpy's rfft of the rows in the packed layout (h columns, column 0
    X[0] + i X[h]; complex), its columns in ``perm`` order if given."""
    h = x.shape[-1] // 2
    X = torch.fft.rfft(x.double(), dim=-1)
    P = X[..., :h].clone()
    P[..., 0] = torch.complex(X[..., 0].real, X[..., h].real)
    if perm is not None:
        P = P[..., torch.as_tensor(perm, device=x.device)]
    return P.to(torch.complex64)


def zdif_perm(n):
    from mpifft4py_tpu_torch.ops import zdif
    return zdif.zdif_perm(n)


def sweep_packed_rfft(torch, lib, stream):
    """The packed r2c at every even n in 4..2048 (natural order) and at n
    = 512, 768, 1024 (DIF order); input and spectrum aligned and one value
    into larger buffers; forward against float64 rfft (1e-5 of max |X|),
    round trip through the library's packed c2r (1e-6 of max |x|; its real
    rows stay aligned).  Returns the failures."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    bad, worst = [], [0.0, 0.0]
    rows = 37

    def view(count, off):
        return torch.empty(count + off, device="cuda")[off:]

    cases = [(n, False) for n in range(4, 2049, 2)] + [
        (n, True) for n in (512, 768, 1024)]
    for n, dif in cases:
        if n % 256 == 0 and not dif:
            print(f"sweep: n = {n}, {len(bad)} failures so far", flush=True)
        h = n // 2
        twf = (twiddles(torch, h, h, -1), twiddles(torch, n, h, -1))
        twb = (twiddles(torch, h, h, 1), twiddles(torch, n, h, 1))
        fwd_fn = lib.packed_rfft_zdif_launch if dif else lib.packed_rfft_launch
        bwd_fn = (lib.packed_irfft_zdif_launch if dif
                  else lib.packed_irfft_launch)
        for off in (0, 1):
            x = view(rows * n, off)
            x.copy_(torch.randn(rows * n, generator=gen, device="cuda"))
            x = x.view(rows, n)
            yr, yi = (view(rows * h, off).view(rows, h) for _ in "ri")
            back = view(rows * n, 0).view(rows, n)
            rc = fwd_fn(x.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                        twf[0].data_ptr(), twf[1].data_ptr(), rows, n,
                        stream)
            rc2 = bwd_fn(yr.data_ptr(), yi.data_ptr(), back.data_ptr(),
                         twb[0].data_ptr(), twb[1].data_ptr(), rows, n,
                         stream)
            ref = packed_ref(torch, x, zdif_perm(n) if dif else None)
            torch.cuda.synchronize()
            fwd, trip = rel(torch.complex(yr, yi), ref), rel(back, x)
            worst = [max(worst[0], fwd), max(worst[1], trip)]
            if rc or rc2 or not fwd <= 1e-5 or not trip <= 1e-6:
                bad.append(f"n={n} dif={dif} off={off}: rc {rc}/{rc2} fwd "
                           f"{fwd:.3e} round trip {trip:.3e}")
    print(f"sweep: even n in 4..2048 natural, 512/768/1024 DIF, x 2 "
          f"offsets; worst fwd {worst[0]:.3e}, round trip {worst[1]:.3e}; "
          f"{len(bad)} failures")
    return bad


def axis_io(torch, lib, stream, c64, shape, offs, gen, tws):
    """(x, run): a complex (pre, n, post) input in a view ``offs[0]``
    values into a larger buffer (planar: each plane), and run(a, inv) ->
    (rc, y), the library's c2c of the middle axis of ``a`` into a view
    ``offs[1]`` values in (``a`` is x or an earlier output); tws: the
    twiddles by (n, inverse)."""
    pre, n, post = shape
    count = pre * n * post

    def view(off):
        if c64:
            return torch.empty(count + off, dtype=torch.complex64,
                               device="cuda")[off:].view(shape)
        return [torch.empty(count + off, device="cuda")[off:].view(shape)
                for _ in range(2)]

    def cplx(v):
        return v if c64 else torch.complex(*v)

    xv = view(offs[0])
    z = torch.complex(*(torch.randn(shape, generator=gen, device="cuda")
                        for _ in range(2)))
    if c64:
        xv.copy_(z)
    else:
        xv[0].copy_(z.real)
        xv[1].copy_(z.imag)
    x = cplx(xv)
    planes = {id(x): xv}    # a planar output's own planes, by its id

    def run(a, inv):
        tw = tws[(n, inv)]
        src = a if c64 else planes[id(a)]
        y = view(offs[1])
        if c64:
            rc = lib.fft_axis_c64_launch(src.data_ptr(), y.data_ptr(),
                                         tw.data_ptr(), pre, n, post, inv,
                                         stream)
        else:
            rc = lib.fft_axis_launch(src[0].data_ptr(), src[1].data_ptr(),
                                     y[0].data_ptr(), y[1].data_ptr(),
                                     tw.data_ptr(), pre, n, post, inv, stream)
        out = cplx(y)
        planes[id(out)] = y
        return rc, out
    return x, run


def sweep_fft_axis(torch, lib, stream):
    """The c2c along the middle axis of (pre, n, post) at every supported_c2c
    n in 2..1024, pre in {1, 3}, post in {1, 5, 129, 4096}, both layouts,
    input and output aligned and 1-3 values into larger buffers: forward
    against torch.fft (1e-5 of max |twin|), round trip (1e-6 of max |x|).
    Returns the failures."""
    from mpifft4py_tpu_torch.ops.fft3d import supported_c2c
    gen = torch.Generator(device="cuda").manual_seed(1)
    bad, worst, count = [], [0.0, 0.0], 0
    ns = [n for n in range(2, 1025) if supported_c2c(n)]
    for n in ns:
        if n % 128 == 0:
            print(f"sweep: n = {n}, {len(bad)} failures so far", flush=True)
        tws = {(n, inv): twiddles(torch, n, n, 1 if inv else -1)
               for inv in (0, 1)}
        for pre in (1, 3):
            for post in (1, 5, 129, 4096):
                if post == 4096 and pre == 3 and n > 512:
                    continue
                for c64 in (False, True):
                    for offs in ((0, 0), (1 + n % 3, 1 + (n + post) % 3)):
                        x, run = axis_io(torch, lib, stream, c64,
                                         (pre, n, post), offs, gen, tws)
                        for inv in (0, 1):
                            rc, y = run(x, inv)
                            rc2, back = run(y, 1 - inv)
                            ref = (torch.fft.ifft if inv else torch.fft.fft)(
                                x, dim=1)
                            torch.cuda.synchronize()
                            fwd, trip = rel(y, ref), rel(back, x)
                            worst = [max(worst[0], fwd), max(worst[1], trip)]
                            count += 1
                            if rc or rc2 or not fwd <= 1e-5 or \
                                    not trip <= 1e-6:
                                bad.append(
                                    f"n={n} pre={pre} post={post} c64={c64} "
                                    f"offs={offs} inv={inv}: rc {rc}/{rc2} "
                                    f"fwd {fwd:.3e} round trip {trip:.3e}")
    print(f"sweep: {len(ns)} supported_c2c n in 2..1024 x pre {{1, 3}} x "
          f"post {{1, 5, 129, 4096}} x 2 layouts x 2 offsets x 2 "
          f"directions ({count} cases); worst fwd {worst[0]:.3e}, round "
          f"trip {worst[1]:.3e}; {len(bad)} failures")
    return bad


def cases_fft_last(torch, dev, gen, stream):
    """(row, shape, call(lib), got() -> (kernel's, torch.fft's), torch.fft
    call, bytes) at rows 10, 10 (n = 384) and 20."""
    out = []
    for row, rows, n, c64 in (("row 10", 65536, 256, False),
                              ("row 10", 147456, 384, False),
                              ("row 20", 65536, 129, True)):
        t = twiddles(torch, n, n, -1)
        if c64:
            x = torch.complex(*(torch.randn((rows, n), generator=gen,
                                            device=dev) for _ in range(2)))
            y = torch.empty_like(x)

            def call(lib, x=x, y=y, t=t, rows=rows, n=n):
                return lib.fft_last_c64_launch(x.data_ptr(), y.data_ptr(),
                                               t.data_ptr(), rows, n, 0,
                                               stream)
            out.append((row, f"complex64 ({rows}, {n})", call,
                        lambda x=x, y=y: (y, torch.fft.fft(x, dim=-1)),
                        lambda x=x: torch.fft.fft(x, dim=-1),
                        2 * x.numel() * 8))
        else:
            xr, xi = (torch.randn((rows, n), generator=gen, device=dev)
                      for _ in range(2))
            yr, yi = torch.empty_like(xr), torch.empty_like(xi)
            z = torch.complex(xr, xi)

            def call(lib, xr=xr, xi=xi, yr=yr, yi=yi, t=t, rows=rows, n=n):
                return lib.fft_last_launch(xr.data_ptr(), xi.data_ptr(),
                                           yr.data_ptr(), yi.data_ptr(),
                                           t.data_ptr(), rows, n, 0, 1.0,
                                           stream)
            out.append((row, f"planar ({rows}, {n})", call,
                        lambda yr=yr, yi=yi, z=z: (
                            torch.complex(yr, yi), torch.fft.fft(z, dim=-1)),
                        lambda z=z: torch.fft.fft(z, dim=-1),
                        4 * xr.numel() * 4))
    return out


def cases_planar_rfft(torch, dev, gen, stream):
    """The same at rows 21 and 8 and the 2x2 pencil's z stage."""
    out = []
    for row, rows, n, nf, ld, dbl, scale, c64 in (
            ("row 21", 65536, 256, 129, 129, 0, 1.0, True),
            ("row 8", 442368, 384, 129, 129, 1, 1 / 1.5 ** 3, False),
            ("pencil z", 16384, 256, 129, 130, 0, 1.0, False)):
        h = n // 2
        th, tn = twiddles(torch, h, h, -1), twiddles(torch, n, h, -1)
        x = torch.randn((rows, n), generator=gen, device=dev)
        if c64:
            y = torch.empty((rows, ld), dtype=torch.complex64, device=dev)

            def call(lib, x=x, y=y, th=th, tn=tn, rows=rows, n=n):
                return lib.rfft_c64_launch(x.data_ptr(), y.data_ptr(),
                                           th.data_ptr(), tn.data_ptr(),
                                           rows, n, stream)

            def got(x=x, y=y):
                return y, torch.fft.rfft(x, dim=-1)
            shape = f"({rows}, {n}) -> complex64 ({rows}, {ld})"
            nb = x.numel() * 4 + y.numel() * 8
        else:
            yr = torch.empty((rows, ld), device=dev)
            yi = torch.empty_like(yr)

            def call(lib, x=x, yr=yr, yi=yi, th=th, tn=tn, rows=rows, n=n,
                     nf=nf, ld=ld, dbl=dbl, scale=scale):
                return lib.planar_rfft_launch(
                    x.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                    th.data_ptr(), tn.data_ptr(), rows, n, nf, ld, dbl,
                    scale, stream)

            def got(x=x, yr=yr, yi=yi, nf=nf, ld=ld, dbl=dbl, scale=scale):
                return (torch.complex(yr, yi),
                        rfft_ref(torch, x, nf, ld, dbl, scale))
            shape = (f"({rows}, {n}) -> planar ({rows}, {ld}) nf={nf}"
                     f"{' doubled' if dbl else ''} scale {scale:.6g}")
            nb = x.numel() * 4 + 2 * yr.numel() * 4
        out.append((row, shape, call, got,
                    lambda x=x: torch.fft.rfft(x, dim=-1), nb))
    return out


def cases_packed_rfft(torch, dev, gen, stream):
    """The same at rows 4 (natural order) and 17 (DIF order), and row 4 at
    `serialFFT` 640^3's z stage (h = 320 = 2^6 * 5, the mixed instance)."""
    out = []
    for row, rows, n, dif in (("row 4", 65536, 256, False),
                              ("row 17", 1024, 1024, True),
                              ("row 4", 409600, 640, False)):
        h = n // 2
        th, tn = twiddles(torch, h, h, -1), twiddles(torch, n, h, -1)
        x = torch.randn((rows, n), generator=gen, device=dev)
        yr = torch.empty((rows, h), device=dev)
        yi = torch.empty_like(yr)

        def call(lib, x=x, yr=yr, yi=yi, th=th, tn=tn, rows=rows, n=n,
                 dif=dif):
            fn = lib.packed_rfft_zdif_launch if dif else lib.packed_rfft_launch
            return fn(x.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                      th.data_ptr(), tn.data_ptr(), rows, n, stream)

        def got(x=x, yr=yr, yi=yi, n=n, dif=dif):
            return (torch.complex(yr, yi),
                    packed_ref(torch, x, zdif_perm(n) if dif else None))
        shape = (f"({rows}, {n}) -> packed planar ({rows}, {h})"
                 f"{' DIF order' if dif else ''}")
        out.append((row, shape, call, got,
                    lambda x=x: torch.fft.rfft(x, dim=-1),
                    x.numel() * 4 + 2 * yr.numel() * 4))
    return out


def cases_fft_axis(torch, dev, gen, stream):
    """The same at row 1 (the x stage), the y stage and the 3-stack, n =
    384 along axes 0 and 1 and the 3/2 rule's y stage, row 19 (complex64),
    NS2D 1024^2's x stage and the widened plans n = 640 and 1016."""
    out = []
    for row, shape, axis, c64 in (
            ("row 1", (256, 256, 128), 0, False),
            ("y stage", (256, 256, 128), 1, False),
            ("3-stack y", (3, 256, 256, 128), 2, False),
            ("n=384 x", (384, 384, 384), 0, False),
            ("n=384 y", (384, 384, 384), 1, False),
            ("3/2 y", (3, 384, 384, 129), 2, False),
            ("row 19", (256, 256, 129), 1, True),
            ("NS2D x", (1024, 512), 0, False),
            ("n=640", (640, 32768), 0, False),
            ("n=1016", (1016, 32768), 0, False)):
        n = shape[axis]
        pre = int(np.prod(shape[:axis]))
        post = int(np.prod(shape[axis + 1:]))
        t = twiddles(torch, n, n, -1)
        xr, xi = (torch.randn(shape, generator=gen, device=dev)
                  for _ in range(2))
        z = torch.complex(xr, xi)
        if c64:
            y = torch.empty_like(z)

            def call(lib, z=z, y=y, t=t, pre=pre, n=n, post=post):
                return lib.fft_axis_c64_launch(z.data_ptr(), y.data_ptr(),
                                               t.data_ptr(), pre, n, post,
                                               0, stream)

            def got(z=z, y=y, axis=axis):
                return y, torch.fft.fft(z, dim=axis)
            nb = 2 * z.numel() * 8
            del xr, xi
        else:
            yr, yi = torch.empty_like(xr), torch.empty_like(xi)

            def call(lib, xr=xr, xi=xi, yr=yr, yi=yi, t=t, pre=pre, n=n,
                     post=post):
                return lib.fft_axis_launch(xr.data_ptr(), xi.data_ptr(),
                                           yr.data_ptr(), yi.data_ptr(),
                                           t.data_ptr(), pre, n, post, 0,
                                           stream)

            def got(yr=yr, yi=yi, z=z, axis=axis):
                return torch.complex(yr, yi), torch.fft.fft(z, dim=axis)
            nb = 4 * xr.numel() * 4
        out.append((row, f"{'complex64' if c64 else 'planar'} {shape} "
                         f"axis {axis}", call, got,
                    lambda z=z, axis=axis: torch.fft.fft(z, dim=axis), nb))
    return out


def cases_rhs_pointwise(torch, dev, gen, stream):
    """The same for rows P1-P3, their eager twins in place of torch.fft."""
    from mpifft4py_tpu_torch.ops import fft3d as p3
    from mpifft4py_tpu_torch.utils import spectral
    shape = (3, 512, 512, 257)
    k = spectral.factored_wavenumbers(shape[1:], None, 257, device=dev)
    kp = [v.data_ptr() for v in k]
    u, f = (torch.complex(*(torch.randn(shape, generator=gen, device=dev)
                            for _ in "ri")) for _ in "uf")
    y = torch.empty_like(u)
    out = [("row P1 rhs_curl", str(shape),
            lambda lib: lib.rhs_curl_launch(u.data_ptr(), *kp, y.data_ptr(),
                                            *shape[1:], stream),
            lambda: (y, p3.rhs_curl_ref(u, *k)),
            lambda: p3.rhs_curl_ref(u, *k), 2 * u.nbytes),
           ("row P3 rhs_leray_visc", str(shape),
            lambda lib: lib.rhs_leray_visc_launch(
                f.data_ptr(), u.data_ptr(), *kp, y.data_ptr(), *shape[1:], NU,
                stream),
            lambda: (y, p3.rhs_leray_visc_ref(f, u, *k, NU)),
            lambda: p3.rhs_leray_visc_ref(f, u, *k, NU), 3 * u.nbytes)]
    for n in (512, 768):
        a, b = (torch.randn((3, n, n, n), generator=gen, device=dev)
                for _ in "ab")
        z = torch.empty_like(a)
        out.append(("row P2 rhs_cross", f"(3, {n}, {n}, {n})",
                    lambda lib, a=a, b=b, z=z: lib.rhs_cross_launch(
                        a.data_ptr(), b.data_ptr(), z.data_ptr(),
                        a[0].numel(), stream),
                    lambda a=a, b=b, z=z: (z, p3.rhs_cross_ref(a, b)),
                    lambda a=a, b=b: p3.rhs_cross_ref(a, b), 3 * a.nbytes))
    return out


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
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="fft_last")
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
    libs = build(args.kernel, srcs, args.edit)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    sweep, cases = {"fft_last": (sweep_fft_last, cases_fft_last),
                    "planar_rfft": (sweep_planar_rfft, cases_planar_rfft),
                    "packed_rfft": (sweep_packed_rfft,
                                    cases_packed_rfft),
                    "fft_axis": (sweep_fft_axis,
                                 cases_fft_axis),
                    "rhs_pointwise": (None,
                                      cases_rhs_pointwise)}[args.kernel]
    plain = KERNELS[args.kernel].get("plain", "torch.fft")
    if args.sweep and sweep is None:
        raise SystemExit(f"--kernel {args.kernel} has no sweep")
    if args.sweep:
        bad = sweep(torch, libs[(list(libs)[-1][0], "full")], stream)
        for b in bad[:20]:
            print(f"sweep FAIL {b}")
        if bad:
            raise SystemExit("the sweep failed")

    results = []
    for row, shape, call, got, lib_fn, nb in cases(torch, dev, gen, stream):
        def launch(lib):
            rc = call(lib)
            if rc:
                raise SystemExit(f"launch failed: CUDA error {rc}")
        for key, lib in libs.items():
            if key[1] == "full":
                launch(lib)
                a, b = got()
                torch.cuda.synchronize()
                err = rel(a, b)
                print(f"check {row} {shape} {key[0]} full: rel err "
                      f"{err:.3e}")
                if err > 1e-5:
                    raise SystemExit(f"the full kernel disagrees with "
                                     f"{plain}")
        order = list(libs.items())
        times = {k: [] for k in libs}
        lib_ms = [median_ms(torch, lib_fn, args.iters)]
        for key, lib in order + order[::-1]:
            times[key].append(median_ms(torch, lambda: launch(lib),
                                        args.iters))
        lib_ms.append(median_ms(torch, lib_fn, args.iters))
        for key in libs:
            ms = times[key]
            print(f"time {row} {shape} {key[0]} {key[1]}: "
                  f"{ms[0]:.4f} / {ms[1]:.4f} ms, "
                  f"{nb / min(ms) / 1e9:.3f} TB/s "
                  f"({100 * nb / (min(ms) * 1e-3) / HBM:.1f}% of 3.35)")
            results.append(dict(row=row, shape=shape, src=key[0],
                                variant=key[1], ms=ms, bytes=nb))
        print(f"time {row} {shape} {plain}: {lib_ms[0]:.4f} / "
              f"{lib_ms[1]:.4f} ms")
        results.append(dict(row=row, shape=shape, src=plain,
                            variant="library", ms=lib_ms, bytes=nb))
    out = ROOT / "chiprun_out" / f"ab_{args.kernel}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(dict(card=smi, results=results), indent=1))
    print(json.dumps(dict(card=smi[0] if smi else None, n=len(results))))


if __name__ == "__main__":
    main()
