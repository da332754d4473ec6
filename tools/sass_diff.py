#!/usr/bin/env python3
r"""Compare the SASS of the port's kernels between two source trees.

    python3 tools/sass_diff.py [--rename 'REGEX=>REPL' ...] DIR_A DIR_B

DIR_A and DIR_B are copies of ``mpifft4py_tpu_torch/ops/csrc`` (e.g. a
parent commit unpacked with ``git archive`` under ``build/parent/`` and the
package's own).  Builds every source of ``ops/_build.SOURCES`` in each with
the package's nvcc flags (``-c``, one nvcc a source, all started together,
under ``build/sass_diff/``), disassembles each object with ``cuobjdump
-sass``, splits it by function and prints, for each source, how many
functions are identical, and names those that differ or exist in one tree
only.  Each ``--rename`` rewrites the mangled names of both trees before
they are compared, so a function whose template arguments changed type
(e.g. a bool that became an enum, which also shifts the mangled
substitution indices of its parameters) is matched with its old instance:
``--rename 'planar_rfft_kernelILb([01])E=>planar_rfft_kernel<\1>'
--rename 'planar_rfft_kernelIL[^E]*E(\d)E=>planar_rfft_kernel<\1>'
--rename '(planar_rfft_kernel<\d>Lb[01]EEEvPKfPf)S4_PK6float2S7_=>\1S3_PK6float2S6_'``.
Writes the lists to ``chiprun_out/sass_diff.json``.  Needs ``nvcc`` (the
machine with the card).
"""

import argparse
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mpifft4py_tpu_torch.ops import _build  # noqa: E402


def cuobjdump():
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    raise SystemExit("cuobjdump not found")


# an anonymous namespace's mangled name carries a hash of the source's path
ANON = re.compile(r"\d*_GLOBAL__N__[0-9a-f]+_\d+_\w+?_[0-9a-f]{8}(?=\d)")


def functions(sass, renames=()):
    """{mangled name: its SASS lines}, anonymous namespaces' path hashes
    replaced by one name, each (REGEX, REPL) of ``renames`` applied to the
    names, and runs of blanks by one."""
    out, name = {}, None
    for line in ANON.sub("_GLOBAL__N_", sass).splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            for pat, repl in renames:
                name = re.sub(pat, repl, name)
            out[name] = []
        elif name is not None:
            # the listing pads its columns to the file's longest line
            out[name].append(" ".join(line.split()))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs=2, metavar="DIR")
    ap.add_argument("--rename", action="append", default=[],
                    help="REGEX=>REPL, applied to the names of both trees")
    args = ap.parse_args()
    renames = [r.split("=>", 1) for r in args.rename]
    dirs = [Path(d).resolve() for d in args.dirs]
    out = ROOT / "build" / "sass_diff"
    nvcc = _build._nvcc()
    jobs = []
    for i, d in enumerate(dirs):
        (out / str(i)).mkdir(parents=True, exist_ok=True)
        for src in _build.SOURCES:
            obj = out / str(i) / (src + ".o")
            jobs.append((i, src, obj, subprocess.Popen(
                [nvcc, *_build.FLAGS, "-c", "-I", str(d), "-o", str(obj),
                 str(d / src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    sass = {}
    for i, src, obj, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {dirs[i]}/{src}:\n{log}")
        sass[(i, src)] = functions(subprocess.run(
            [cuobjdump(), "-sass", str(obj)], capture_output=True, text=True,
            check=True).stdout, renames)
    report = {}
    for src in _build.SOURCES:
        a, b = sass[(0, src)], sass[(1, src)]
        same = sorted(f for f in a.keys() & b.keys() if a[f] == b[f])
        diff = sorted(f for f in a.keys() & b.keys() if a[f] != b[f])
        report[src] = dict(identical=len(same), differ=diff,
                           only_a=sorted(a.keys() - b.keys()),
                           only_b=sorted(b.keys() - a.keys()))
        print(f"sass {src}: {len(same)} identical, {len(diff)} differ, "
              f"{len(a.keys() - b.keys())} only in A, "
              f"{len(b.keys() - a.keys())} only in B")
        for f in diff:
            # the first differing instructions, by position
            pairs = [(i, x, y) for i, (x, y) in enumerate(
                itertools.zip_longest(a[f], b[f], fillvalue="")) if x != y]
            print(f"sass {src}: differs {f} ({len(a[f])} / {len(b[f])} "
                  f"lines, {len(pairs)} differ by position), e.g.")
            for i, x, y in pairs[:3]:
                print(f"    {i}: {x!r}\n    {i}: {y!r}")
        for f in report[src]["only_a"]:
            print(f"sass {src}: only in A {f}")
        for f in report[src]["only_b"]:
            print(f"sass {src}: only in B {f}")
    dest = ROOT / "chiprun_out" / "sass_diff.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(dict(a=str(dirs[0]), b=str(dirs[1]),
                                    sources=report), indent=1))


if __name__ == "__main__":
    main()
