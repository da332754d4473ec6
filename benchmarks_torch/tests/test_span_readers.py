"""The readers of the program's spans (``metrics/*_ms.*``, source
``program_span``): their arithmetic on a given report, what they do
without a segment, without device times or without the spans, their note
where the unit span's count differs from the traced units, and a
rehearsal on the CPU in which a chunk of each cell runs with its spans on
and CUDA events faked on the host clock."""

import sys
import time

import pytest
import torch

import run
import traced
from conftest import small_cell

CELLS = ["tgv1600_512.packed", "slab_r2c_512.roundtrip",
         "tgv1600_512.padded", "tgv1600_512.complex"]
SEED = 2 ** 31 + 2 ** 20 + 11
STEP, RHS = "mpifft.solver.step", "mpifft.solver.rhs"
FWD, BWD = "mpifft.transform.forward", "mpifft.transform.backward"
BOUNDARY = "mpifft.transform.boundary"
# metric -> (spans whose self device time it sums, the unit span)
READS = {"integrator_ms.step": ((STEP,), STEP),
         "rhs_pointwise_ms.step": ((RHS,), STEP),
         "transform_ms.step": ((FWD, BWD), STEP),
         "boundary_ms.step": ((BOUNDARY,), STEP),
         "boundary_ms.roundtrip": ((BOUNDARY,), FWD)}


def _span_metrics(got):
    return {k: v for k, v in got.items() if k in READS}


def _listed(cell):
    return {m["name"] for m in cell.per_layer
            if m["source"] == "program_span"}


def _totals(count, self_device_s):
    return {"count": count, "host_s": 1.0, "self_host_s": 0.5,
            "device_s": self_device_s, "self_device_s": self_device_s}


REPORT = {"mpifft.solver.run": _totals(1, 0.001),
          STEP: _totals(10, 0.012), RHS: _totals(40, 0.6),
          FWD: _totals(40, 0.4), BWD: _totals(80, 0.6),
          BOUNDARY: _totals(120, 0.5)}


@pytest.fixture
def report(monkeypatch):
    from mpifft4py_tpu_torch.utils import profiling
    spans = dict(REPORT)
    monkeypatch.setattr(profiling, "report", lambda: spans)
    return spans


def _read(name, units):
    cell = run.load_cell(name)
    rec = run.RunRecord(cell, {}, segment=traced.Segment(1.0, 1.0, units))
    return _span_metrics({k: v["value"] for k, v in
                          run.read_per_layer(rec).items()}), rec


def test_arithmetic_on_a_report(report):
    got, rec = _read("tgv1600_512.complex", 10)
    assert got == pytest.approx({"integrator_ms.step": 1.2,
                                 "rhs_pointwise_ms.step": 60.0,
                                 "transform_ms.step": 100.0,
                                 "boundary_ms.step": 50.0})
    assert not rec.notes
    got, _ = _read("tgv1600_512.packed", 10)
    assert set(got) == {"integrator_ms.step", "transform_ms.step"}
    got, rec = _read("slab_r2c_512.roundtrip", 40)
    assert got == pytest.approx({"boundary_ms.roundtrip": 12.5})
    assert not rec.notes


def test_a_count_other_than_the_units_is_noted(report):
    got, rec = _read("tgv1600_512.padded", 20)
    # divided by the spans' count, not the segment's units
    assert got["integrator_ms.step"] == pytest.approx(1.2)
    assert len(rec.notes) == 4
    assert all("10 mpifft.solver.step spans against 20" in n
               for n in rec.notes)


def test_nothing_without_a_segment(report):
    for name in CELLS:
        cell = run.load_cell(name)
        assert not _span_metrics(run.read_per_layer(run.RunRecord(cell, {})))


def test_nothing_without_device_times(report):
    for t in report.values():
        t["device_s"] = t["self_device_s"] = None
    assert _read("tgv1600_512.complex", 10)[0] == {}


def test_nothing_without_the_spans(report):
    report.clear()
    assert _read("tgv1600_512.complex", 10)[0] == {}


def test_nothing_from_a_program_without_spans(monkeypatch):
    # a program before the spans: the module does not import
    import mpifft4py_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "profiling", raising=False)
    monkeypatch.setitem(sys.modules, "mpifft4py_tpu_torch.utils.profiling",
                        None)
    for name in CELLS:
        got, rec = _read(name, 10)
        assert got == {} and not rec.notes


class _HostEvent:
    """A CUDA event's surface on the host clock: the rehearsal's device
    runs on the host, so an event completes when it is recorded."""

    def record(self):
        self.t = time.perf_counter()

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_of_a_traced_chunk(name, monkeypatch):
    from mpifft4py_tpu_torch.utils import profiling
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda enable_timing: _HostEvent())
    cell = small_cell(name)
    entry = run.entry_class(cell)(cell.cfg, cell.traffic, SEED, "cpu")
    entry.warm_up()
    profiling.reset()
    profiling.enable()
    try:
        units = entry.chunk()
    finally:
        profiling.disable()
    spans = profiling.report()
    rec = run.RunRecord(cell, {}, segment=traced.Segment(1.0, 1.0, units))
    got = _span_metrics({k: v["value"] for k, v in
                         run.read_per_layer(rec).items()})
    profiling.reset()
    assert set(got) == _listed(cell) and got
    for metric, v in got.items():
        names, unit = READS[metric]
        assert spans[unit]["count"] == units
        assert v == pytest.approx(1e3 * sum(
            spans[n]["self_device_s"] for n in names) / units)
        assert v > 0
    assert not rec.notes
