"""A rehearsal of the four-rank cell ``tgv1600_1024.slab_p4`` on the CPU:
``run.run_cell`` with ``comm`` on 4 gloo ranks (spawned processes, one
torch thread each, a ``FileStore`` under the test's temporary directory),
the configuration cut to a test size by this file's own table.  The
program's run gives the result's keys and ``correct``; the TF32 control,
an altered state and an unchanged one come out not correct."""

import io
import json
import multiprocessing as mp
import os
import queue
import traceback

import pytest

from conftest import BENCH

CELL = "tgv1600_1024.slab_p4"
P = 4
SEED = 2 ** 31 + 2 ** 20 + 13       # beyond 32 signed bits
# the packed layout needs (N2/2) % 128 == 0 and N0, N1 divisible by P; the
# perturbation stays inside the 2/3 rule's modes
SMALL = {"N": [16, 16, 256], "perturbation": {"kmax": 2, "amplitude": 0.01}}
CASES = [("program", None), ("control", None), ("program", "altered"),
         ("program", "unchanged")]
TIMEOUT = 300


def _fault(name):
    def unchanged(entry):
        entry.solver.step = lambda state: state

    def altered(entry):
        run_ = entry.solver.run

        def run(state, n, monitor_every):
            out, e = run_(state, n, monitor_every=monitor_every)
            out = out.clone()
            out.view(-1)[out.numel() // 3] += out.abs().max()
            return out, e
        entry.solver.run = run
    return {None: None, "altered": altered, "unchanged": unchanged}[name]


def _rank(rank, store, outq):
    import sys
    sys.path[:0] = [BENCH, os.path.dirname(BENCH)]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, P),
                            rank=rank, world_size=P)
    try:
        import run
        cell = run.load_cell(CELL)
        cell.cfg = dict(cell.cfg, **SMALL)
        got = []
        for system, fault in CASES:
            result, _ = run.run_cell(cell, SEED, 0.0, 0, device="cpu",
                                     system=system, prepare=_fault(fault),
                                     comm=dist.group.WORLD,
                                     log=io.StringIO())
            got.append(result)
        outq.put((rank, True, got))
    except BaseException:           # reported to the test, which raises it
        outq.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ctx = mp.get_context("spawn")
    outq = ctx.Queue()
    store = str(tmp_path_factory.mktemp("gloo4") / "store")
    procs = [ctx.Process(target=_rank, args=(r, store, outq), daemon=True)
             for r in range(P)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(P):
            rank, ok, res = outq.get(timeout=TIMEOUT)
            got[rank] = (ok, res)
    except queue.Empty:
        pytest.fail(f"a rank gave no result in {TIMEOUT} s")
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
    failed = [f"rank {r}:\n{res}" for r, (ok, res) in sorted(got.items())
              if not ok]
    assert not failed, "\n".join(failed)
    return [got[r][1] for r in range(P)]


def test_program_is_correct_and_ranks_agree(results):
    import run
    cell = run.load_cell(CELL)
    result = results[0][0]
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checked"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert result["device"]["count"] == P
    assert set(result["checked"]) == set(cell.limits)
    json.dumps(result)
    # every rank compared the same reduced numbers
    for r in range(1, P):
        assert results[r][0]["checked"] == result["checked"]


@pytest.mark.parametrize("case", range(1, len(CASES)),
                         ids=[f"{s}-{f}" for s, f in CASES[1:]])
def test_control_and_faults_are_not_correct(results, case):
    assert results[0][case]["correct"] is False
    assert results[0][case]["failed"] > 0
