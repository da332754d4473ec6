"""The traced segment of a run: which launches the program made, and the
reduction of ``torch.profiler``'s Chrome trace to what the per-layer
readers (``metrics/``) read.

``LaunchRecorder`` stands between the program and its kernel library
(``mpifft4py_tpu_torch.ops._build``): every call of a ``<entry>_launch``
C function is recorded with its arguments (the launch's own shapes) and
wrapped in a ``bench.launch/<i>`` annotation, so each device kernel it
issues is tied to the launch through the profiler's correlation ids.
Kernels outside any such annotation are the program's other work (torch
elementwise, ``cat``, copies, reductions): the spectral glue.
"""

import bisect
import importlib.util
import os
import re
from dataclasses import dataclass, field

import yardstick

WINDOW = "bench.window"
LAUNCH = "bench.launch/"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# the hand-written kernels' names in the trace (profile_step.py's groups)
HAND_WRITTEN = ("curl_ifft_x_kernel", "product_rfft_z_kernel",
                "fft_x_epilogue_kernel", "packed_irfft_kernel",
                "fft_axis_kernel", "planar_rfft_kernel",
                "planar_irfft_kernel", "fft_last_kernel")


def group(name):
    """A kernel's group: each hand-written kernel with its template
    arguments, ``cat``, reductions, copies, or other elementwise work
    (``profile_step.py``'s ``group``)."""
    for key in HAND_WRITTEN:
        if key in name:
            m = re.search(re.escape(key) + r"(<(?:[^<>]|<[^<>]*>)*>)?", name)
            return m.group(0)
    low = name.lower()
    if "cat" in low:
        return "cat"
    if "reduce" in low:
        return "reduce"
    if "copy" in low or "memcpy" in low:
        return "copy"
    return "elementwise/other"


class LaunchRecorder:
    """Records the program's kernel launches while installed (a context
    manager).  ``calls[i]`` is ``(entry, args)``: the C function's name
    without ``_launch`` and its arguments without the stream."""

    def __init__(self):
        self.calls = []
        self._saved = None

    def __enter__(self):
        from mpifft4py_tpu_torch.ops import _build
        lib = _build.load()
        self._saved = lib
        _build._lib = _RecordingLib(lib, self.calls)
        return self

    def __exit__(self, *exc):
        from mpifft4py_tpu_torch.ops import _build
        _build._lib = self._saved
        return False


class _RecordingLib:
    def __init__(self, lib, calls):
        self._lib, self._calls = lib, calls

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if not name.endswith("_launch"):
            return fn
        import torch

        def launch(*args):
            i = len(self._calls)
            self._calls.append((name[:-len("_launch")], args[:-1]))
            with torch.profiler.record_function(f"{LAUNCH}{i}"):
                return fn(*args)
        return launch


@dataclass
class Segment:
    """The traced window reduced: seconds, device busy time (the union of
    the device operations' intervals), and each kernel as (name, seconds,
    launch index or None)."""
    window_s: float
    busy_s: float
    units: int
    kernels: list = field(default_factory=list)
    launches: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)   # (host label, seconds)


def _union(intervals):
    """Merged [a, b) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(events, launches, units):
    """``events``: the Chrome trace's ``traceEvents``; ``launches``: the
    recorder's calls; ``units``: steps or round trips in the segment.
    Times in the trace are microseconds."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace holds no {WINDOW!r} annotation")
    w0 = win[0]["ts"]
    w1 = w0 + win[0]["dur"]

    def inside(e):
        return e["ts"] < w1 and e["ts"] + e.get("dur", 0) > w0

    dev = [e for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
    # launch annotations by thread, then the runtime call each holds
    ann = {}
    for e in events:
        if e.get("cat") == "user_annotation" and \
                e.get("name", "").startswith(LAUNCH):
            ann.setdefault(e.get("tid"), []).append(
                (e["ts"], e["ts"] + e["dur"], int(e["name"][len(LAUNCH):])))
    for v in ann.values():
        v.sort()
    starts = {tid: [a for a, _, _ in v] for tid, v in ann.items()}
    corr_launch = {}
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        c = (e.get("args") or {}).get("correlation")
        v = ann.get(e.get("tid"))
        if c is None or not v:
            continue
        j = bisect.bisect_right(starts[e.get("tid")], e["ts"]) - 1
        if j >= 0 and v[j][0] <= e["ts"] <= v[j][1]:
            corr_launch[c] = v[j][2]
    kernels = []
    for e in dev:
        if e.get("cat") != "kernel":
            continue
        c = (e.get("args") or {}).get("correlation")
        kernels.append((e["name"], e["dur"] * 1e-6, corr_launch.get(c)))
    merged = _union((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                    for e in dev)
    busy = sum(b - a for a, b in merged) * 1e-6
    return Segment(window_s=(w1 - w0) * 1e-6, busy_s=busy, units=units,
                   kernels=kernels, launches=list(launches),
                   idle_gaps=_idle_gaps(events, merged, w0, w1))


def _idle_gaps(events, merged, w0, w1):
    """Each idle gap of the device inside the window, labelled by the
    innermost host operation running at its middle on the thread that
    drives the window; the seconds summed by label, longest first."""
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    tid = next((e.get("tid") for e in events if e.get("name") == WINDOW),
               None)
    host = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
            if e.get("cat") in HOST_CATS and e.get("tid") == tid
            and not e.get("name", "").startswith("bench.")]
    host.sort()
    starts = [h[0] for h in host]
    totals = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        j = bisect.bisect_right(starts, mid)
        label, best = "host: no traced operation", None
        for s, t, name in reversed(host[max(0, j - 64):j]):
            if s <= mid <= t and (best is None or t - s < best):
                label, best = name, t - s
        totals[label] = totals.get(label, 0.0) + (b - a) * 1e-6
    return sorted(totals.items(), key=lambda kv: -kv[1])


def _work(entry):
    """``work/<entry>.py``'s ``work`` function, or None."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "work",
                        entry + ".py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location("work_" + entry, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.work


def kernel_roofline(rec):
    """Σ bound / Σ device time over the segment's hand-written launches
    that have a work function, in %; the others are named in
    ``rec.notes`` and left out of both sums."""
    seg = rec.segment
    if seg is None:
        return None
    times = {}
    for _, s, i in seg.kernels:
        if i is not None:
            times[i] = times.get(i, 0.0) + s
    fns, missing, bound, spent = {}, set(), 0.0, 0.0
    for i, s in times.items():
        entry, args = seg.launches[i]
        if entry not in fns:
            fns[entry] = _work(entry)
        if fns[entry] is None:
            missing.add(entry)
            continue
        bound += yardstick.bound_s(*fns[entry](args))
        spent += s
    if missing:
        rec.notes.append(f"kernel_roofline: no work/ file for "
                         f"{sorted(missing)}, left out of both sums")
    return 100.0 * bound / spent if spent > 0 else None


def idle_percent(rec):
    seg = rec.segment
    if seg is None or seg.window_s <= 0 or seg.busy_s <= 0:
        return None
    return 100.0 * (1.0 - seg.busy_s / seg.window_s)
