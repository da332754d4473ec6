"""The benchmark's CPU tests: its arithmetic, its references, and a
rehearsal of a run at test sizes with the program's CPU twins.

    python -m pytest benchmarks_torch/tests -q
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

# test sizes: the packed layout needs (N2/2) % 128 == 0; the perturbation
# stays inside the 2/3 rule's modes
SMALL = {"tgv1600_512": {"N": [16, 16, 256],
                         "perturbation": {"kmax": 2, "amplitude": 0.01}},
         "slab_r2c_512": {"N": [16, 16, 32]}}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cell(name):
    """The cell ``name`` with its configuration cut to a test size."""
    import run
    cell = run.load_cell(name)
    cell.cfg = dict(cell.cfg, **SMALL[cell.cfg["name"]])
    return cell
