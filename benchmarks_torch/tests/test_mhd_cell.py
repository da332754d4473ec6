"""The cell ``mhd_512.mhd_packed`` on the CPU at a test size, the program
on its CPU twins: a run is correct and has the result's keys; the TF32
control, an altered state and an unchanged (unstepped) state are not
correct.  Its reference against the port's float64 complex step is
tier-1's ``tests/test_torch_mhd_plain_reference.py``.  Then its three
readers (``momentum_ms.step``, ``induction_ms.step``,
``cross2_roofline.step``) on a given report and a synthetic trace, without
them, and in a traced chunk rehearsed with CUDA events on the host clock."""

import io
import json
import sys

import pytest
import torch

import run
import traced
import yardstick
from test_span_readers import _HostEvent, _totals

CELL = "mhd_512.mhd_packed"
SEED = 2 ** 31 + 2 ** 20 + 13       # beyond 32 signed bits
# the packed layout needs (N2/2) % 128 == 0; the perturbation stays
# inside the 2/3 rule's modes
SMALL = {"N": [16, 16, 256], "perturbation": {"kmax": 2, "amplitude": 0.01}}
MOM, IND = "mpifft.solver.momentum", "mpifft.solver.induction"
STEP, RHS = "mpifft.solver.step", "mpifft.solver.rhs"
NEW = ("momentum_ms.step", "induction_ms.step", "cross2_roofline.step")


def _small_cell():
    cell = run.load_cell(CELL)
    cell.cfg = dict(cell.cfg, **SMALL)
    return cell


def _run(system="program", prepare=None, seed=SEED):
    return run.run_cell(_small_cell(), seed, 0.0, 0, device="cpu",
                        system=system, prepare=prepare, log=io.StringIO())


def test_rehearsal():
    result, checked = _run()
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checked"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] == 10
    cell = run.load_cell(CELL)
    assert set(result["metrics"]) == {"step_ms", "peak_mem_gib", "setup_s"}
    assert set(result["checked"]) == set(cell.limits) == set(checked) == \
        {"u_err", "b_err", "state_l2"}
    assert {m["name"] for m in cell.per_layer} >= set(NEW)
    json.dumps(result)


def test_same_seed_same_inputs():
    a, _ = _run(seed=5)
    b, _ = _run(seed=5)
    c, _ = _run(seed=6)
    assert a["checked"] == b["checked"] != c["checked"]


def test_control_is_not_correct():
    result, _ = _run(system="control")
    assert result["correct"] is False and result["failed"] > 0


def _unchanged(entry):
    entry.solver.step = lambda state: state


def _altered_b(entry):
    """The field's half of the state altered after each chunk."""
    run_ = entry.solver.run

    def altered(state, n, monitor_every):
        out, e = run_(state, n, monitor_every=monitor_every)
        out = out.clone()
        b = out[0, 4]                       # b_y's real plane
        b.view(-1)[b.numel() // 3] += out[:, 3:].abs().max()
        return out, e
    entry.solver.run = altered


@pytest.mark.parametrize("fault,prepare", [("state unchanged", _unchanged),
                                           ("b altered", _altered_b)])
def test_fault_is_not_correct(fault, prepare):
    result, checked = _run(prepare=prepare)
    assert result["correct"] is False
    if fault == "b altered":
        assert checked["b_err"][0] > checked["b_err"][1]
        assert checked["u_err"][0] <= checked["u_err"][1]


# -- the readers ----------------------------------------------------------------

REPORT = {STEP: _totals(10, 0.012), RHS: _totals(40, 0.3),
          MOM: dict(_totals(40, 0.05), device_s=0.9),
          IND: dict(_totals(40, 0.04), device_s=0.6)}


def _launch_args(op, rows=512 * 512, n=512):
    return (0,) * 8 + (rows, n, op)


def _segment(units=10):
    """A synthetic trace of 1000 us: a cross2 launch (op 1) and a cross
    launch (op 0) of the cross kernel, one kernel each."""
    ev = [{"cat": "user_annotation", "name": traced.WINDOW, "ts": 0,
           "dur": 1000, "tid": 1}]
    for i, (ts, corr) in enumerate(((10, 7), (40, 8))):
        ev += [{"cat": "user_annotation", "name": f"{traced.LAUNCH}{i}",
                "ts": ts, "dur": 20, "tid": 1},
               {"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts + 5, "dur": 5, "tid": 1,
                "args": {"correlation": corr}}]
    ev += [{"cat": "kernel", "name": "void product_rfft_z_kernel<1, false>",
            "ts": 100, "dur": 400, "args": {"correlation": 7}},
           {"cat": "kernel", "name": "void product_rfft_z_kernel<0, false>",
            "ts": 500, "dur": 300, "args": {"correlation": 8}}]
    launches = [("cross_rfft_z", _launch_args(1)),
                ("cross_rfft_z", _launch_args(0))]
    return traced.reduce_trace(ev, launches, units=units)


@pytest.fixture
def report(monkeypatch):
    from mpifft4py_tpu_torch.utils import profiling
    spans = {k: dict(v) for k, v in REPORT.items()}
    monkeypatch.setattr(profiling, "report", lambda: spans)
    return spans


def _read(segment):
    rec = run.RunRecord(run.load_cell(CELL), {"step_ms": 270.0},
                        segment=segment)
    got = {k: v["value"] for k, v in run.read_per_layer(rec).items()}
    return {k: v for k, v in got.items() if k in NEW}, rec


def test_readers_on_a_segment(report):
    got, rec = _read(_segment())
    # inclusive device time (children counted) over the 10 step spans
    bound = 4 * 4 * 3 * 512 ** 3 + 2 * 4 * 3 * 512 * 512 * 256
    flops = 2.5 * 3 * 512 ** 3 * 9
    assert got == pytest.approx({
        "momentum_ms.step": 90.0, "induction_ms.step": 60.0,
        "cross2_roofline.step": 100 * yardstick.bound_s(bound, flops)
        / 400e-6})
    assert not rec.notes


def test_counts_other_than_the_steps_and_the_rhs_are_noted(report):
    report[MOM]["count"] = 39
    got, rec = _read(_segment(units=20))
    assert got["momentum_ms.step"] == pytest.approx(90.0)
    assert any("39 mpifft.solver.momentum spans against 40" in n
               for n in rec.notes)
    for metric in ("momentum_ms.step", "induction_ms.step"):
        assert f"{metric}: 10 mpifft.solver.step spans against 20 traced " \
            "units" in rec.notes


def test_nothing_without_a_segment(report):
    assert _read(None)[0] == {}


def test_nothing_without_the_spans_or_cross2(report):
    del report[MOM], report[IND]
    seg = _segment()
    seg.launches[0] = ("cross_rfft_z", _launch_args(0))
    assert _read(seg)[0] == {}


def test_nothing_from_a_program_without_spans(monkeypatch):
    import mpifft4py_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "profiling", raising=False)
    monkeypatch.setitem(sys.modules, "mpifft4py_tpu_torch.utils.profiling",
                        None)
    got, rec = _read(_segment())
    assert set(got) == {"cross2_roofline.step"} and not rec.notes


def test_rehearsal_of_a_traced_chunk(monkeypatch):
    """A chunk with the spans on, CUDA events on the host clock: both
    span readers read the spans' inclusive times, 4 a step each."""
    from mpifft4py_tpu_torch.utils import profiling
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda enable_timing: _HostEvent())
    cell = _small_cell()
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
    got = {k: v["value"] for k, v in run.read_per_layer(rec).items()}
    profiling.reset()
    assert not rec.notes
    for metric, name in (("momentum_ms.step", MOM),
                         ("induction_ms.step", IND)):
        assert spans[name]["count"] == 4 * units
        assert got[metric] == pytest.approx(
            1e3 * spans[name]["device_s"] / units)
        assert spans[name]["device_s"] > spans[name]["self_device_s"] > 0
