#!/usr/bin/env python3
"""Readings for a cell's limits, several seeds in one process: the run of
``run.py`` (entry, window, check) once a seed, with the program or with
the control (the reference in TF32 put in the program's place), each
seed's compared numbers printed as one JSON line.  The benchmark's own
runs never run the control.

    python3 benchmarks_torch/calibrate.py --workload <cell> \\
        --seeds 11,12,13 [--seconds 2] [--system program|control]
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--system", choices=("program", "control"),
                    default="program")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(1, os.path.dirname(HERE))
    import torch

    import run
    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 1
    cell = run.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, checked = run.run_cell(cell, seed, args.seconds, 0,
                                       system=args.system, t0=t0)
        print(json.dumps({"workload": cell.name, "system": args.system,
                          "seed": seed, "correct": result["correct"],
                          "metrics": {k: v["value"] for k, v in
                                      result["metrics"].items()},
                          "checked": {k: v for k, (v, _) in
                                      checked.items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
        del result
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
