"""A rehearsal of run.py on the CPU at test sizes, the program on its CPU
twins: argument parsing, cells found by name, the result's keys, the
trace reduction and its readers; then the control and each fault the
cells can have, which must come out not correct."""

import io
import json

import pytest
import torch

import run
import traced
from conftest import small_cell

CELLS = ["tgv1600_512.packed", "slab_r2c_512.roundtrip",
         "tgv1600_512.padded", "tgv1600_512.complex"]
SEED = 2 ** 31 + 2 ** 20 + 7       # beyond 32 signed bits


def _run(name, system="program", prepare=None, seed=SEED):
    return run.run_cell(small_cell(name), seed, 0.0, 0, device="cpu",
                        system=system, prepare=prepare, log=io.StringIO())


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "tgv1600_512.packed", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_bad_arguments_and_unknown_cell():
    with pytest.raises(SystemExit):
        run.main(["--workload", "tgv1600_512.packed", "--seed", "x",
                  "--seconds", "1"])
    with pytest.raises(KeyError):
        run.load_cell("no_such.cell")


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal(name):
    result, checked = _run(name)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checked"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    cell = run.load_cell(name)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = result["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] >= 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["checked"]) == set(cell.limits) == set(checked)
    json.dumps(result)


def test_same_seed_same_inputs():
    a, _ = _run("tgv1600_512.complex", seed=5)
    b, _ = _run("tgv1600_512.complex", seed=5)
    c, _ = _run("tgv1600_512.complex", seed=6)
    assert a["checked"] == b["checked"] != c["checked"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    result, _ = _run(name, system="control")
    assert result["correct"] is False and result["failed"] > 0


def _unchanged(entry):
    entry.solver.step = lambda state: state


def _altered_state(entry):
    run_ = entry.solver.run

    def altered(state, n, monitor_every):
        out, e = run_(state, n, monitor_every=monitor_every)
        out = out.clone()
        out.view(-1)[out.numel() // 3] += out.abs().max()
        return out, e
    entry.solver.run = altered


def _altered(method):
    def prepare(entry):
        fn = getattr(entry.fft, method)

        def altered(x, *a, **k):
            y = fn(x, *a, **k).clone()
            y.view(-1)[y.numel() // 2] += y.abs().max()
            return y
        setattr(entry.fft, method, altered)
    return prepare


FAULTS = [(c, "state unchanged", _unchanged) for c in CELLS if "tgv" in c] \
    + [(c, "state altered", _altered_state) for c in CELLS if "tgv" in c] \
    + [("slab_r2c_512.roundtrip", "spectrum altered", _altered("fftn")),
       ("slab_r2c_512.roundtrip", "result altered", _altered("ifftn"))]


@pytest.mark.parametrize("name,fault,prepare", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_fault_is_not_correct(name, fault, prepare):
    result, _ = _run(name, prepare=prepare)
    assert result["correct"] is False


# -- the traced segment -------------------------------------------------------

def _trace():
    """A synthetic Chrome trace: a window of 1000 us on thread 1 with two
    hand-written launches (one kernel each) and one glue kernel, and a
    sync the host waited in."""
    ev = [
        {"cat": "user_annotation", "name": traced.WINDOW, "ts": 0,
         "dur": 1000, "tid": 1},
        {"cat": "user_annotation", "name": traced.LAUNCH + "0", "ts": 10,
         "dur": 20, "tid": 1},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 15,
         "dur": 5, "tid": 1, "args": {"correlation": 7}},
        {"cat": "user_annotation", "name": traced.LAUNCH + "1", "ts": 40,
         "dur": 20, "tid": 1},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 45,
         "dur": 5, "tid": 1, "args": {"correlation": 8}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 70,
         "dur": 5, "tid": 1, "args": {"correlation": 9}},
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 80,
         "dur": 900, "tid": 1},
        {"cat": "kernel", "name": "void fft_axis_kernel<false, 4>(float*)",
         "ts": 100, "dur": 300, "args": {"correlation": 7}},
        {"cat": "kernel", "name": "void planar_rfft_kernel<(Out)2>(float*)",
         "ts": 400, "dur": 200, "args": {"correlation": 8}},
        {"cat": "kernel", "name": "at::native::CatArrayBatchedCopy",
         "ts": 700, "dur": 100, "args": {"correlation": 9}},
    ]
    launches = [("fft_axis", (0,) * 5 + (1, 256, 256 * 128, 0)),
                ("packed_rfft", (0,) * 5 + (256 * 256, 256))]
    return traced.reduce_trace(ev, launches, units=2)


def test_reduce_trace():
    seg = _trace()
    assert seg.window_s == pytest.approx(1e-3)
    assert seg.busy_s == pytest.approx(600e-6)
    assert [i for _, _, i in seg.kernels] == [0, 1, None]
    # gaps 0-100, 600-700, 800-1000 us, all inside the sync but the first
    labels = dict(seg.idle_gaps)
    assert labels["cudaStreamSynchronize"] == pytest.approx(300e-6)
    assert sum(labels.values()) == pytest.approx(400e-6)


def test_readers_on_a_segment():
    cell = run.load_cell("tgv1600_512.packed")
    rec = run.RunRecord(cell, {"step_ms": 150.0}, segment=_trace())
    got = {k: v["value"] for k, v in run.read_per_layer(rec).items()}
    bound = 2 * 134217728 / 3.35e12
    assert got["kernel_roofline.step"] == pytest.approx(
        100 * bound / 500e-6)
    assert got["glue_share.step"] == pytest.approx(100 * 100 / 600)
    assert got["launches.step"] == pytest.approx(1.5)
    assert got["device_idle.step"] == pytest.approx(40.0)
    assert set(got) == {m["name"] for m in cell.per_layer}
    b = run.breakdown(rec.segment)
    assert b["device_ops"][0] == ["fft_axis_kernel<false, 4>",
                                  pytest.approx(300e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_readers_find_nothing_without_a_trace():
    cell = run.load_cell("slab_r2c_512.roundtrip")
    rec = run.RunRecord(cell, {"roundtrip_ms": 7.0})
    assert set(run.read_per_layer(rec)) == {"mfu.roundtrip"}


def test_a_launch_without_work_is_named_and_left_out():
    cell = run.load_cell("slab_r2c_512.roundtrip")
    seg = _trace()
    seg.launches[1] = ("no_such_kernel", ())
    rec = run.RunRecord(cell, {"roundtrip_ms": 7.0}, segment=seg)
    got = run.read_per_layer(rec)["kernel_roofline.roundtrip"]["value"]
    assert got == pytest.approx(100 * 134217728 / 3.35e12 / 300e-6)
    assert any("no_such_kernel" in n for n in rec.notes)
