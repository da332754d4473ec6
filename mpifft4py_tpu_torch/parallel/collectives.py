"""Collective transposes over a ``torch.distributed`` group.

Port of ``mpifft4py_tpu/parallel/collectives.py``.  The reference's
transpose is ``lax.all_to_all(x, axis, split_axis, concat_axis,
tiled=True)`` inside ``shard_map``; here it is ``dist.all_to_all_single``
over the group, with the layout changes around it written out:

* ``transpose(x, group, split_axis, concat_axis)``: block d of ``x`` along
  ``split_axis`` goes to rank d; the blocks received from ranks 0..P−1 are
  concatenated along ``concat_axis`` in rank order — the tiled semantics.
* ``transpose_pipelined(...)``: the array is chunked along a free axis and
  every chunk's all-to-all is posted with ``async_op=True`` before the
  first ``work_fn`` runs, so chunk c+1's exchange flies while chunk c's
  work runs (the reference leaves the overlap to XLA's scheduler).

``all_gather`` and ``all_reduce`` are the group's own collectives.  Every
function takes a tensor or a tuple of tensors (the planar (re, im) pair),
each leaf riding its own collective.  On the card these need a backend
that moves CUDA tensors (NCCL, one card per rank); gloo moves CPU tensors
(the tests), and ``all_reduce`` of CUDA scalars.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

__all__ = ["transpose", "transpose_pipelined", "all_gather", "all_reduce"]


def _leafwise(fn, x):
    return tuple(fn(v) for v in x) if isinstance(x, tuple) else fn(x)


def _send_view(v, P: int, split_axis: int):
    """``v`` with its split axis cut into P blocks, the block axis first,
    contiguous: the send buffer of ``all_to_all_single``."""
    s = list(v.shape)
    if s[split_axis] % P:
        raise ValueError(f"split axis {split_axis} of {tuple(s)} not "
                         f"divisible by {P} ranks")
    s[split_axis:split_axis + 1] = [P, s[split_axis] // P]
    return v.reshape(s).movedim(split_axis, 0).contiguous()


def _recv_merge(r, concat_axis: int):
    """The received (P, …) blocks as one tensor, the block axis merged in
    front of ``concat_axis`` (source rank outermost)."""
    r = r.movedim(0, concat_axis)
    s = list(r.shape)
    s[concat_axis:concat_axis + 2] = [s[concat_axis] * s[concat_axis + 1]]
    return r.reshape(s)


def _post(v, group, split_axis: int):
    P = dist.get_world_size(group)
    send = _send_view(v, P, split_axis)
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=group, async_op=True)
    return work, recv


def transpose(x, group, split_axis: int, concat_axis: int):
    """Tiled all-to-all of ``x`` (or of each tensor of a tuple) over
    ``group``; ``group`` None is a world of one (identity)."""
    if group is None:
        return x

    def one(v):
        work, recv = _post(v, group, split_axis)
        work.wait()
        return _recv_merge(recv, concat_axis)
    return _leafwise(one, x)


def _chunk_bounds(n: int, k: int):
    """k contiguous chunks covering n (the first ones one larger)."""
    base, rem = divmod(n, k)
    bounds, start = [], 0
    for i in range(k):
        size = base + (1 if i < rem else 0)
        if size:
            bounds.append((start, size))
            start += size
    return bounds


def transpose_pipelined(x, group, split_axis: int, concat_axis: int,
                        work_fn: Optional[Callable], pipeline_axis: int,
                        nchunks: int = 4, pre_fn: Optional[Callable] = None):
    """``work_fn(transpose(pre_fn(x)))`` chunked along ``pipeline_axis``, a
    free axis (neither split nor concat, and independent of ``pre_fn``'s
    and ``work_fn``'s transforms; the Hermitian z axis in the slab).  Every
    chunk's all-to-all is posted before the first wait, so the exchanges of
    later chunks fly while earlier chunks' ``work_fn`` runs; results are
    concatenated along ``pipeline_axis``.  Equal, chunk by chunk, to the
    unpipelined composition."""
    work_fn = work_fn or (lambda v: v)
    pre_fn = pre_fn or (lambda v: v)
    first = x[0] if isinstance(x, tuple) else x
    bounds = _chunk_bounds(int(first.shape[pipeline_axis]), int(nchunks))
    if group is None or len(bounds) <= 1:
        return work_fn(transpose(pre_fn(x), group, split_axis, concat_axis))
    posted = []
    for start, size in bounds:
        chunk = _leafwise(lambda v: v.narrow(pipeline_axis, start, size), x)
        posted.append(_leafwise(lambda v: _post(v, group, split_axis),
                                pre_fn(chunk)))
    outs = []
    for p in posted:
        leaves = p if isinstance(x, tuple) else (p,)
        for work, _ in leaves:
            work.wait()
        got = tuple(_recv_merge(r, concat_axis) for _, r in leaves)
        outs.append(work_fn(got if isinstance(x, tuple) else got[0]))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(vs, dim=pipeline_axis) for vs in zip(*outs))
    return torch.cat(outs, dim=pipeline_axis)


def all_gather(x, group, axis: int):
    """Tiled all-gather along ``axis``: the ranks' blocks concatenated in
    rank order (``lax.all_gather(..., tiled=True)``)."""
    if group is None:
        return x

    def one(v):
        v = v.contiguous()
        parts = [torch.empty_like(v) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, v, group=group)
        return torch.cat(parts, dim=axis)
    return _leafwise(one, x)


def all_reduce(t, group):
    """The sum of ``t`` over the group, as a new tensor on ``t``'s device.
    Gloo takes CUDA tensors through the host, so a scalar (an energy, a
    band norm) reduces the same way on either backend."""
    if group is None:
        return t
    out = t.detach().clone()
    if out.device.type == "cuda" and dist.get_backend(group) == "gloo":
        host = out.cpu()
        dist.all_reduce(host, group=group)
        return host.to(t.device)
    dist.all_reduce(out, group=group)
    return out
