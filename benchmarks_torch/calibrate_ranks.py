#!/usr/bin/env python3
"""Readings for the limits of a cell on several cards: ``calibrate.py``'s
runs (the entry, its window and its check, once a seed, with the program
or with the TF32 control) with one rank a card, the ranks launched and
joined as ``run.py`` does; rank 0 prints each seed's compared numbers as
one JSON line.

    python3 benchmarks_torch/calibrate_ranks.py --workload <cell> \\
        --seeds 11,12,13 [--seconds 0] [--system program|control]
"""

import argparse
import io
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--system", choices=("program", "control"),
                    default="program")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(1, os.path.dirname(HERE))
    import torch

    import run
    cell = run.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"calibrate_ranks.py: {cell.name} needs {cell.chips} CUDA "
              f"cards", file=sys.stderr)
        return 1
    procs = []
    if run.RANK_ENV not in os.environ:
        port = str(run._free_port())
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *argv],
            env={**os.environ, run.RANK_ENV: str(r), "PERFBENCH_PORT": port})
            for r in range(1, cell.chips)]
        os.environ[run.RANK_ENV], os.environ["PERFBENCH_PORT"] = "0", port
    rank = int(os.environ[run.RANK_ENV])
    torch.cuda.set_device(rank)
    import torch.distributed as dist
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{os.environ['PERFBENCH_PORT']}",
        world_size=cell.chips, rank=rank)
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            result, checked = run.run_cell(
                cell, seed, args.seconds, 0, system=args.system,
                comm=dist.group.WORLD, t0=t0,
                log=sys.stderr if rank == 0 else io.StringIO())
            if rank == 0:
                print(json.dumps({
                    "workload": cell.name, "system": args.system,
                    "seed": seed, "correct": result["correct"],
                    "metrics": {k: v["value"] for k, v in
                                result["metrics"].items()},
                    "checked": {k: v for k, (v, _) in checked.items()},
                    "seconds": time.perf_counter() - t0}), flush=True)
            del result
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        for p in procs:
            p.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
