#!/usr/bin/env python3
"""Probe, not a cell: does ``slab.R2C`` run across cards?  One rank a
card under ``torchrun``, the port's default communication, a 512³ round
trip of a seeded N(0, 1) field: each rank's spectral block against the
float64 transform of the whole field (the P == 1 answer), its round trip
against its input block, and the round trip's time (host clock over
synchronised round trips, median of 5 samples of 10).

    python3 -c 'from mpifft4py_tpu_torch.ops import _build; _build.load()'
    python3 -m torch.distributed.run --nproc-per-node=4 \\
        benchmarks_torch/probe_slab_p4.py [--n 512]

Without a card it runs on the CPU over gloo (a rehearsal at a small n).
"""

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=512)
    N = (ap.parse_args().n,) * 3
    sys.path.insert(0, HERE)
    sys.path.insert(1, os.path.dirname(HERE))
    import numpy as np
    import torch
    import torch.distributed as dist

    from mpifft4py_tpu_torch.parallel import runtime
    from mpifft4py_tpu_torch.slab import R2C
    from reference.r2c import R2C as PlainR2C

    runtime.initialize()
    rank, P = dist.get_rank(), dist.get_world_size()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.cuda.is_available() else torch.device("cpu"))
    FFT = R2C(np.array(N), np.array([2 * np.pi] * 3), None, "single",
              device=dev)
    g = torch.Generator(device=dev).manual_seed(2 ** 31 + 99)
    u_all = torch.randn(N, generator=g, dtype=torch.float32, device=dev)
    u = u_all[FFT.real_local_slice(rank)].contiguous()
    fu = FFT.fftn(u)
    v = FFT.ifftn(fu)
    sync(dev)
    ref = PlainR2C(N, "float64").fftn(u_all)
    del u_all
    ref_blk = ref[FFT.complex_local_slice(rank)]
    fwd = float((fu.to(ref.dtype) - ref_blk).abs().max() / ref.abs().max())
    del ref, ref_blk
    rt = float((v - u).abs().max() / u.abs().max())
    samples = []
    for _ in range(5):
        dist.barrier()
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(10):
            fu = FFT.fftn(u)
            v = FFT.ifftn(fu)
        sync(dev)
        dist.barrier()
        samples.append((time.perf_counter() - t0) / 10 * 1e3)
    out = [None] * P
    dist.all_gather_object(out, {"rank": rank, "fwd_err": fwd,
                                 "rt_err": rt,
                                 "roundtrip_ms": statistics.median(samples),
                                 "card": (torch.cuda.get_device_name(dev)
                                          if dev.type == "cuda" else "cpu")})
    if rank == 0:
        print(json.dumps({"P": P, "communication": FFT.communication,
                          "shape": list(N), "ranks": out}), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
