"""Reproducer: the first multithreaded float32 ``torch.sin`` of a CPU process.

    JAX_PLATFORMS=cpu python tests/probe_torch_first_sin.py [count [cases]]

Starts ``count`` (default 20) fresh processes for each case (default all
three, or a comma-separated list) and tallies what each saw:

* ``mesh-jax``: the JAX solver is built as tests/test_torch_packed.py
  builds it, then ``torch.sin`` of the (16, 32, 256) x0 mesh is taken twice
  and both results are held against float64: how many elements differ,
  in which index range, and each call's largest error;
* ``mesh-nojax``: the same without the JAX package;
* ``tg-jax``: the JAX solver is built, then the port's ``taylor_green``
  runs first, for the packed and the complex layout: are the two states
  bit-equal, as test_packed_diagnostics_match_reference asserts?

Not collected by pytest (no ``test_`` prefix); a diagnostic, not a test.
"""

import collections
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = ("mesh-jax", "mesh-nojax", "tg-jax")


def child(case):
    sys.path[:0] = [os.path.dirname(HERE), HERE]
    import torch
    from mpifft4py_tpu_torch import slab
    if case.endswith("-jax"):
        import test_torch_packed as T
        from jax.experimental.pallas import tpu as pltpu
        with pltpu.force_tpu_interpret_mode():
            _, Tc, Tp = T._solvers()
        FFT = Tp.FFT
    else:
        FFT = slab.R2C(np.array((16, 32, 256)), np.array([2 * np.pi] * 3),
                       None, "single", device="cpu")
    if case == "tg-jax":
        return {"equal": bool(torch.equal(Tp.taylor_green(),
                                          Tp.to_packed(Tc.taylor_green())))}
    # at once: building another solver first closed the window (0 of 20)
    x = FFT.get_local_mesh()[0]
    a, b = torch.sin(x), torch.sin(x)
    ref = torch.sin(x.double())
    d = (a != b).flatten().nonzero().flatten()
    return {"n_diff": int(d.numel()),
            "range": [int(d.min()), int(d.max())] if d.numel() else None,
            "err_first": float((a.double() - ref).abs().max()),
            "err_second": float((b.double() - ref).abs().max()),
            "threads": torch.get_num_threads()}


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])))
        return 0
    count = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    for case in sys.argv[2].split(",") if len(sys.argv) > 2 else CASES:
        seen = collections.Counter()
        for _ in range(count):
            out = subprocess.run(
                [sys.executable, __file__, "--child", case],
                capture_output=True, text=True, check=True)
            seen[out.stdout.strip().splitlines()[-1]] += 1
        print(f"{case}: {count} fresh processes")
        for line, n in seen.most_common():
            print(f"  {n} x {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
