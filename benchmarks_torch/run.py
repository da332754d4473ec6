#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port: one cell, one run.

    python3 benchmarks_torch/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<mix>.json``); the mix names the entry
(``entries/<entry>.py``) that drives the program.  The run builds the
cell's inputs on the card from the seed, warms up (one unit of work), then
runs the entry's chunks until ``--seconds`` have passed; the window's wall
time over the units it completed is the cell's time metric.  With
``--trace 1`` the mix's ``trace_chunks`` more chunks (1 by default) run
under ``torch.profiler``, after one that warms it up, and the cell's
per-layer readers (``metrics/<name>.py``) read it, with each hand-written
launch's bytes and flops from ``work/<entry>.py``.  Then the program's
state is freed and the entry compares what its last chunk produced with
the plain reference (``reference/``); each number and its limit
(``limits/<cell>.json``) go to standard error as the last lines and into
the result, the last line of standard output.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
1 and prints no result.  A cell on several cards runs one rank a card
(``torch.distributed`` over NCCL); rank 0 prints the result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RANK_ENV = "PERFBENCH_RANK"        # set on the ranks of a multi-card cell
GIB = 2 ** 30


@dataclass
class Cell:
    """A cell of BENCHMARK.json with its files read."""
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


@dataclass
class RunRecord:
    """What a per-layer reader reads: the cell, the end-to-end values of
    this run and, in a traced run, the traced segment (``traced.Segment``)."""
    cell: Cell
    e2e: dict
    segment: object = None
    notes: list = field(default_factory=list)


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(name, bench=None):
    """The cell ``name`` of BENCHMARK.json, its files found by name."""
    bench = bench or _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    cfg = _json(os.path.join(ROOT, cfgs[w["config"]]["file"]))
    traffic = _json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    limits = _json(os.path.join(HERE, "limits", name + ".json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)
                 and any(e["name"] == m["moves"] for e in e2e)]
    return Cell(name, int(w["chips"]), cfg, traffic, limits, e2e, per_layer)


def entry_class(cell):
    return load_module(os.path.join(HERE, "entries",
                                    cell.traffic["entry"] + ".py"),
                       "entry_" + cell.traffic["entry"]).Entry


def _profiled_chunks(entry, chunks):
    """``chunks`` chunks under the profiler and the launch recorder, after
    one chunk that warms the profiler up unrecorded; returns the reduced
    segment."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    import traced as tr
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with tr.LaunchRecorder() as rec, \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA],
                        schedule=schedule(wait=0, warmup=1, active=1),
                        on_trace_ready=lambda p: p.export_chrome_trace(
                            path)) as prof:
            entry.chunk()
            prof.step()
            with torch.profiler.record_function(tr.WINDOW):
                units = sum(entry.chunk() for _ in range(chunks))
            prof.step()
        events = _json(path)["traceEvents"]
    return tr.reduce_trace(events, rec.calls, units)


def read_per_layer(rec):
    """Each per-layer reader of the cell on ``rec``; a reader that finds
    nothing returns None and its metric is left out."""
    out = {}
    for m in rec.cell.per_layer:
        mod = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                          "metric_" + m["name"].replace(".", "_"))
        v = mod.read(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def breakdown(seg):
    """The ten device groups that took most time and the ten longest
    idle-gap labels, in seconds."""
    import traced as tr
    groups = {}
    for name, s, _ in seg.kernels:
        g = tr.group(name)
        groups[g] = groups.get(g, 0.0) + s
    ops = sorted(groups.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in seg.idle_gaps[:10]]}


def run_cell(cell, seed, seconds, trace, device="cuda", system="program",
             prepare=None, comm=None, t0=T0, log=sys.stderr):
    """One run of ``cell``; returns the result's dict (the last line) and
    the compared numbers {name: (value, limit)}.  ``prepare(entry)``, if
    given, runs after the entry is built (the fault tests break the timed
    path there)."""
    import torch
    cuda = torch.device(device).type == "cuda"
    entry = entry_class(cell)(cell.cfg, cell.traffic, seed, device,
                              system=system, comm=comm)
    if prepare is not None:
        prepare(entry)
    entry.warm_up()
    if cuda:
        torch.cuda.synchronize()
    start = time.perf_counter()
    setup_s = start - t0
    units, chunks, last = 0, [], start
    while True:
        n = entry.chunk()
        now = time.perf_counter()
        units += n
        chunks.append((now - last) / n * 1e3)
        last = now
        if now - start >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = {"setup_s": setup_s, "peak_mem_gib": peak / GIB,
           cell.traffic["time_metric"]: window_s / units * 1e3}
    rec = RunRecord(cell, e2e)
    metrics, device_info = {}, {}
    if trace:
        seg = rec.segment = _profiled_chunks(
            entry, int(cell.traffic.get("trace_chunks", 1)))
        metrics = read_per_layer(rec)
        device_info = {"busy_s": seg.busy_s, "window_s": seg.window_s}
        print(f"traced: {seg.units} {entry.unit}s, {len(seg.kernels)} "
              f"kernels, {len(seg.launches)} hand-written launches, busy "
              f"{seg.busy_s:.6f} s of {seg.window_s:.6f} s", file=log)
        for note in rec.notes:
            print(note, file=log)
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    q = statistics.quantiles(chunks, n=4) if len(chunks) > 1 else chunks * 3
    print(f"chunks: {len(chunks)}, ms a {entry.unit}: min {min(chunks):.4f}, "
          f"quartiles {q[0]:.4f} / {q[1]:.4f} / {q[2]:.4f}, max "
          f"{max(chunks):.4f}", file=log)
    print(f"window: {units} {entry.unit}s in {window_s:.6f} s; set-up "
          f"{setup_s:.6f} s; peak {peak} bytes; card: {card(cuda)}", file=log)
    values = entry.check()
    if set(values) != set(cell.limits):
        raise KeyError(f"compared {sorted(values)}, limits for "
                       f"{sorted(cell.limits)}")
    checked = {k: (float(values[k]), float(cell.limits[k]))
               for k in cell.limits}
    correct = all(v <= lim for v, lim in checked.values())
    result = {"correct": correct, "attempted": units,
              "failed": 0 if correct else entry.checked_units,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device,
                         "kind": (torch.cuda.get_device_name() if cuda
                                  else device),
                         "count": cell.chips, "memory_peak_bytes": peak,
                         **device_info}}
    if trace:
        result["breakdown"] = breakdown(rec.segment)
    result["checked"] = {k: {"value": v, "limit": lim}
                         for k, (v, lim) in checked.items()}
    return result, checked


def card(cuda):
    """The card's name, power limit and draw, clocks, temperature and
    active throttle reasons as nvidia-smi reads them."""
    if not cuda:
        return "none (CPU)"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.mem,temperature.gpu,"
             "clocks_throttle_reasons.active", "--format=csv,noheader"],
            capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_ranks(argv, chips):
    """Rank 0 here, ranks 1.. as child processes of this command; each
    rank joins one NCCL group on its card."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               *argv],
                              env={**os.environ, RANK_ENV: str(r),
                                   "PERFBENCH_PORT": str(port)})
             for r in range(1, chips)]
    os.environ[RANK_ENV], os.environ["PERFBENCH_PORT"] = "0", str(port)
    return procs


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("run.py: no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"run.py: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    import mpifft4py_tpu_torch  # noqa: F401  (the program, from the checkout)
    procs, comm = [], None
    if cell.chips > 1:
        if RANK_ENV not in os.environ:
            procs = _launch_ranks(argv, cell.chips)
        rank = int(os.environ[RANK_ENV])
        torch.cuda.set_device(rank)
        import torch.distributed as dist
        dist.init_process_group(
            "nccl", init_method=f"tcp://localhost:"
                                f"{os.environ['PERFBENCH_PORT']}",
            world_size=cell.chips, rank=rank)
        comm = dist.group.WORLD
    try:
        result, checked = run_cell(cell, args.seed, args.seconds, args.trace,
                                   comm=comm)
    finally:
        if comm is not None:
            torch.distributed.destroy_process_group()
        for p in procs:
            p.wait()
    if os.environ.get(RANK_ENV, "0") != "0":
        return 0
    for k, (v, lim) in checked.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
