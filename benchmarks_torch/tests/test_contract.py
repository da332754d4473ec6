"""BENCHMARK.json against the benchmark's contract: names and units of
the allowed characters, every file it names present and under the
benchmark's folder, every metric with its reader, every cell with its
limits; and no module of the benchmark imports JAX or the JAX package."""

import ast
import json
import os
import re

import pytest

from conftest import BENCH

ROOT = os.path.dirname(BENCH)
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmarks_torch"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert len(SPEC["command"]) <= 32
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer") + (("source",) if group ==
                                           "configs" else ()):
                if key in e:
                    assert LINE.match(e[key]), (e["name"], key)
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    metrics = [n for m, n in names if m]
    assert len(metrics) == len(set(metrics))
    assert len({w["name"] for w in SPEC["workloads"]}) == \
        len(SPEC["workloads"])
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) \
        == len(SPEC["workloads"])


def test_entries_have_exactly_their_keys():
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }
    for group, keys in allowed.items():
        for e in SPEC[group]:
            assert set(e) <= keys and set(e) >= keys - {"workloads"}, e
    for m in SPEC["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_files_found_by_name():
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmarks_torch/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) \
                as f:
            traffic = json.load(f)
        assert os.path.exists(os.path.join(BENCH, "entries",
                                           traffic["entry"] + ".py"))
        assert os.path.exists(os.path.join(BENCH, "limits",
                                           w["name"] + ".json"))
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        # each cell it lists reports the metric it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                             cells))
    for cell in cells:
        reported = [n for n, m in e2e.items()
                    if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


def _modules():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "mpifft4py_tpu"), (path, m)
