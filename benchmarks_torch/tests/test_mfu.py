"""The nominal flop counts of the mfu readers."""

import math

import pytest

import run
from conftest import BENCH


def _reader(name):
    return run.load_module(f"{BENCH}/metrics/{name}.py", name)


@pytest.mark.parametrize("cell,points", [
    ("tgv1600_512.packed", 512 ** 3), ("tgv1600_512.complex", 512 ** 3),
    ("tgv1600_512.padded", 768 ** 3)])
def test_mfu_step(cell, points):
    c = run.load_cell(cell)
    rec = run.RunRecord(c, {"step_ms": 150.0})
    flops = 36 * 2.5 * points * math.log2(points)
    got = _reader("mfu.step").read(rec)
    assert got == pytest.approx(100 * flops / 0.150 / 67e12, rel=1e-12)


def test_mfu_step_at_512_reads_about_three_percent_at_150_ms():
    c = run.load_cell("tgv1600_512.packed")
    got = _reader("mfu.step").read(run.RunRecord(c, {"step_ms": 150.0}))
    # 36 × 2.5 × 2^27 × 27 = 326.2 GFLOP a step
    assert got == pytest.approx(326.16e9 / 0.150 / 67e12 * 100, rel=1e-4)


def test_mfu_roundtrip():
    c = run.load_cell("slab_r2c_512.roundtrip")
    n = 512 ** 3
    got = _reader("mfu.roundtrip").read(
        run.RunRecord(c, {"roundtrip_ms": 7.0}))
    assert got == pytest.approx(100 * 5 * n * 27 / 7e-3 / 67e12, rel=1e-12)


def test_mfu_reads_nothing_without_its_time():
    c = run.load_cell("tgv1600_512.packed")
    assert _reader("mfu.step").read(run.RunRecord(c, {})) is None
