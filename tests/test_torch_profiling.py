"""The port's spans (``mpifft4py_tpu_torch.utils.profiling``) on the CPU.

Self times on a fake clock (host) and fake CUDA events (device); the span
counts of NS3D RK4 runs in the complex, packed and 3/2-rule
configurations; the shared no-op context while tracing is off; the spans
in a ``torch.profiler`` trace, recorded in its active phase only; and the
solver's state, bit for bit the same with tracing on and off.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from mpifft4py_tpu_torch.models import NavierStokes3D
from mpifft4py_tpu_torch.slab import C2C, R2C
from mpifft4py_tpu_torch.utils import profiling

TAU = 2 * np.pi
# (spectral_layout, dealias, N): the packed layout needs (N2/2) % 128 == 0
CONFIGS = {"complex": ("complex", "2/3-rule", (16, 16, 16)),
           "packed": ("packed", "2/3-rule", (16, 16, 256)),
           "padded": ("complex", "3/2-rule", (16, 16, 16))}


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()
    torch.set_num_threads(n)


def _solver(config):
    layout, dealias, N = CONFIGS[config]
    FFT = R2C(np.array(N), np.array([TAU] * 3), None, "single", device="cpu")
    s = NavierStokes3D(FFT, nu=1 / 1600, dt=0.01, dealias=dealias,
                       spectral_layout=layout, integrator="RK4")
    return s, s.taylor_green()


class _Clock:
    """perf_counter() returning the given times in turn."""

    def __init__(self, times):
        self._times = iter(times)

    def perf_counter(self):
        return next(self._times)


def _nest(clock_times, monkeypatch):
    """a ⊃ (b, c ⊃ b), each span's ends read from ``clock_times``."""
    monkeypatch.setattr(profiling, "time", _Clock(clock_times))
    profiling.enable()
    with profiling.span("a"):
        with profiling.span("b"):
            pass
        with profiling.span("c"):
            with profiling.span("b"):
                pass
    profiling.disable()


def test_self_time_on_the_host(monkeypatch):
    # a [0, 10], b [1, 4], c [5, 9], b [6, 7]
    _nest([0, 1, 4, 5, 6, 7, 9, 10], monkeypatch)
    r = profiling.report()
    assert r["a"] == {"count": 1, "host_s": 10, "self_host_s": 3,
                      "device_s": None, "self_device_s": None}
    assert (r["b"]["count"], r["b"]["host_s"], r["b"]["self_host_s"]) \
        == (2, 4, 4)
    assert (r["c"]["host_s"], r["c"]["self_host_s"]) == (4, 3)
    # the self times tile the root
    assert sum(t["self_host_s"] for t in r.values()) == 10


class _Event:
    """A CUDA event's surface on a fake device clock (ms); it completes
    once the test says the device has reached it."""

    clock, reached = None, 0.0

    def record(self):
        self.t = next(_Event.clock)

    def query(self):
        return self.t <= _Event.reached

    def synchronize(self):
        _Event.reached = max(_Event.reached, self.t)

    def elapsed_time(self, end):
        return end.t - self.t


def test_self_time_on_the_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", lambda enable_timing: _Event())
    # device ms: a [0, 100], b [10, 40], c [50, 90], b [60, 70]; then a
    # second root d [100, 120]
    _Event.clock = iter([0, 10, 40, 50, 60, 70, 90, 100, 100, 120])
    _Event.reached = 95.0          # the device has not reached a's end
    _nest([0, 1, 4, 5, 6, 7, 9, 10], monkeypatch)
    assert profiling._rec.pending    # a's tree waits for its end event
    _Event.reached = 100.0
    profiling.enable()
    monkeypatch.setattr(profiling, "time", _Clock([11, 12]))
    with profiling.span("d"):       # a root's exit folds a's tree
        pass
    assert len(profiling._rec.pending) == 1
    assert len(profiling._rec.pool) == 8
    r = profiling.report()           # d folded after one synchronise
    assert not profiling._rec.pending
    got = {k: (t["device_s"], t["self_device_s"]) for k, t in r.items()}
    assert got == pytest.approx({"a": (0.1, 0.03), "b": (0.04, 0.04),
                                 "c": (0.04, 0.03), "d": (0.02, 0.02)})


RHS_TRANSFORMS = {"complex": {"mpifft.transform.backward": 2,
                              "mpifft.transform.forward": 1},
                  "packed": {"mpifft.transform.backward": 1,
                             "mpifft.transform.forward": 1},
                  "padded": {"mpifft.transform.backward": 2,
                             "mpifft.transform.forward": 1}}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_span_counts_of_two_rk4_steps(config):
    s, U = _solver(config)
    profiling.enable()
    s.run(U, 2, monitor_every=2)
    profiling.disable()
    r = profiling.report()
    counts = {k: t["count"] for k, t in r.items()}
    assert counts["mpifft.solver.run"] == 1
    assert counts["mpifft.solver.step"] == 2
    assert counts["mpifft.solver.rhs"] == 8
    assert counts["mpifft.solver.monitor"] == 1
    for name, per_rhs in RHS_TRANSFORMS[config].items():
        assert counts[name] == 8 * per_rhs, name
    assert ("mpifft.transform.boundary" in counts) == (config != "packed")
    assert set(counts) <= {"mpifft.solver.run", "mpifft.solver.step",
                           "mpifft.solver.rhs", "mpifft.solver.monitor",
                           "mpifft.transform.forward",
                           "mpifft.transform.backward",
                           "mpifft.transform.boundary"}
    for t in r.values():
        assert t["device_s"] is None and t["self_device_s"] is None
        assert 0 <= t["self_host_s"] <= t["host_s"]
    # the root's self time and its children's times tile it
    run = r["mpifft.solver.run"]
    assert run["host_s"] == pytest.approx(
        run["self_host_s"] + r["mpifft.solver.step"]["host_s"]
        + r["mpifft.solver.monitor"]["host_s"])


# boundary spans a round trip: R2C unpacks and packs (or, under the 2/3
# rule, joins the masked pair and packs); C2C splits its input and joins
# each output; the 3/2 rule adds its truncations and pads
ROUNDTRIPS = [(R2C, None, 2), (R2C, "2/3-rule", 2), (R2C, "3/2-rule", 5),
              (C2C, None, 3), (C2C, "3/2-rule", 9)]


@pytest.mark.parametrize("cls,dealias,boundary", ROUNDTRIPS,
                         ids=[f"{c.__name__}-{d}" for c, d, _ in ROUNDTRIPS])
def test_roundtrip_spans(cls, dealias, boundary):
    FFT = cls(np.array((16, 16, 32)), np.array([TAU] * 3), None, "single",
              device="cpu")
    assert FFT._kernel_ok(dealias)
    shape = FFT.work_shape(dealias)
    u = (torch.randn(shape) if cls is R2C
         else torch.randn(shape, dtype=torch.complex64))
    profiling.enable()
    for _ in range(3):
        FFT.ifftn(FFT.fftn(u, dealias=dealias), dealias=dealias)
    profiling.disable()
    counts = {k: t["count"] for k, t in profiling.report().items()}
    assert counts == {"mpifft.transform.forward": 3,
                      "mpifft.transform.backward": 3,
                      "mpifft.transform.boundary": 3 * boundary}


def test_off_records_nothing():
    assert profiling.span("a") is profiling.span("b")
    s, U = _solver("complex")
    s.run(U, 2, monitor_every=2)
    assert profiling.report() == {}


def test_spans_in_a_profiler_trace_active_phase_only(tmp_path):
    s, U = _solver("packed")
    path = tmp_path / "trace.json"
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(
                     str(path))) as prof:
        U, _ = s.run(U, 1, monitor_every=1)       # warm-up phase
        prof.step()
        U, _ = s.run(U, 2, monitor_every=2)       # active phase
        prof.step()
    counts = {k: t["count"] for k, t in profiling.report().items()}
    assert counts["mpifft.solver.run"] == 1
    assert counts["mpifft.solver.step"] == 2
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"mpifft.solver.run", "mpifft.solver.step", "mpifft.solver.rhs",
            "mpifft.solver.monitor", "mpifft.transform.forward",
            "mpifft.transform.backward"} <= names
    steps = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "mpifft.solver.step"]
    assert len(steps) == 2


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_same_state_with_tracing_on_and_off(config):
    s, U = _solver(config)
    off, e_off = s.run(U, 2, monitor_every=2)
    profiling.enable()
    on, e_on = s.run(U, 2, monitor_every=2)
    profiling.disable()
    assert torch.equal(on, off) and torch.equal(e_on, e_off)
    assert profiling.report()["mpifft.solver.step"]["count"] == 2
