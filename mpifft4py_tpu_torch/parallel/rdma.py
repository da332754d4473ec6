"""The transposes over peer memory: rows 23-27 (``communication="rdma"``).

Port of ``mpifft4py_tpu/parallel/rdma.py``.  On the TPU each is one
Pallas kernel that posts per-peer remote DMAs over ICI.  Here each rank of
a group (the slab's, or one of the pencil's sub-groups: a ``PeerGroup`` a
group, its buffers exchanged within that group only) owns a *symmetric
buffer* per shape: a ``torch.empty`` allocated once and never resized,
whose CUDA IPC handle
(``torch.multiprocessing.reductions.reduce_tensor``) every rank receives
through ``dist.all_gather_object`` and opens, so a device table of P base
pointers lets one kernel load from or store into every rank's buffer.  On
one card (P processes sharing it, a gloo group) the peers' buffers are in
the same HBM; across cards the same loads and stores ride NVLink.  Three
hand-written CUDA kernels (``ops/csrc/``; rows 24-27 are one kernel over
(outer, n, inner) strides, with an entry point each):

* ``peer_a2a`` (row 23, ``rdma_all_to_all``): the tiled all-to-all as a
  strided block copy, block d of this rank's input pushed to slot ``my`` of
  peer d's buffer — ``_stage`` under ``"rdma"`` (the 3/2 rule's chain,
  ``C2C``, the nonlinear term's transpose) and the plane-0 all-gather (an
  all-to-all of the plane repeated P times);
* ``peer_fft_x`` (row 24, ``fused_transpose_fft_x``): the slab forward's
  receive fused with the x c2c, pulling each x-line's N0 points from the
  peers' buffers (the zy stage wrote its pair there);
* ``peer_ifft_x`` (row 25, ``fused_ifft_x_transpose``): the inverse x c2c
  (1/N0) fused with the send, pushing each x-line's rows into the peers'
  buffers, where the zy inverse reads them;
* ``peer_fft_y`` (row 26, ``fused_transpose_fft_y``): the pencil forward's
  P2-group receive fused with the y c2c, pulling each y-line's N1 points
  (this rank's lane block of every peer's z-transformed pair, which the z
  stage wrote into the buffer);
* ``peer_ifft_y`` (row 27, ``fused_ifft_y_transpose``): the inverse y c2c
  (1/N1) fused with the send, pushing each y-line's rows into the peers'
  buffers at this rank's lane block, where the z inverse reads them.

Ordering is on the host, with no in-kernel waiting on another process
(ranks sharing a card run by time slices, so a kernel spinning on a peer's
flag could stall for a whole slice): producer → stream synchronise → group
barrier → peer kernel → stream synchronise → group barrier.  The second
barrier keeps anyone from reusing a buffer a peer still reads.

Each kernel function has a plain twin over torch ops on the same buffer
tables (``*_ref``; the CPU tests hold them against the reference and the
card checks hold the kernels against them), and ``LAUNCHES`` counts the
kernel launches.  The group-level functions run the plain composition for
CPU tensors (the group's ``all_to_all_single`` and
``ops.fft3d.fft_axis_planar_ref``); for CUDA tensors they launch the
kernels or raise — with no CUDA IPC between the ranks they raise, and never
reroute through ``all_to_all_single``.  A result of a group-level function
on the card is a view of a symmetric buffer, valid until the group's next
call on a buffer of that shape: callers consume it at once.
"""

from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

from ..ops import fft3d as p3
from . import collectives

__all__ = ["LAUNCHES", "reset_launches", "SymmetricBuffer", "PeerGroup",
           "a2a_push", "a2a_push_ref", "fft_x_pull", "fft_x_pull_ref",
           "ifft_x_push", "ifft_x_push_ref", "fft_y_pull", "fft_y_pull_ref",
           "ifft_y_push", "ifft_y_push_ref", "rdma_supported",
           "rdma_all_to_all", "rdma_all_gather", "fused_transpose_fft_x",
           "fused_ifft_x_transpose", "fused_transpose_fft_y",
           "fused_ifft_y_transpose"]

LAUNCHES = {"peer_a2a": 0, "peer_fft_x": 0, "peer_ifft_x": 0,
            "peer_fft_y": 0, "peer_ifft_y": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rdma_supported(x) -> bool:
    """The peer kernels move float32 leaves (planar pairs, real fields)."""
    return x.dtype == torch.float32


def _open_handle(handle):
    """A peer's buffer from its ``reduce_tensor`` handle (CUDA IPC)."""
    fn, args = handle
    return fn(*args)


class SymmetricBuffer:
    """One float32 tensor of one shape per rank, and the device table of
    their P base addresses that the peer kernels index.

    ``local`` builds P tensors in this process (the kernel checks and the
    card tests emulate P ranks with it); ``exchange`` allocates this rank's
    tensor and opens the peers' through CUDA IPC, a collective of the
    group."""

    def __init__(self, tensors, rank: int = 0):
        self.tensors = list(tensors)
        self.rank = rank
        self._table = None

    @property
    def P(self) -> int:
        return len(self.tensors)

    def mine(self) -> torch.Tensor:
        return self.tensors[self.rank]

    def table(self) -> torch.Tensor:
        """int64 device tensor of the P base addresses."""
        if self._table is None:
            self._table = torch.tensor([t.data_ptr() for t in self.tensors],
                                       dtype=torch.int64,
                                       device=self.tensors[0].device)
        return self._table

    @classmethod
    def local(cls, P: int, shape, device, rank: int = 0):
        return cls([torch.zeros(tuple(shape), dtype=torch.float32,
                                device=device) for _ in range(P)], rank)

    @classmethod
    def exchange(cls, group, P: int, rank: int, shape, device):
        """Allocate this rank's buffer and open every peer's; raises
        RuntimeError when the ranks cannot map each other's memory."""
        from torch.multiprocessing.reductions import reduce_tensor
        device = torch.device(device)
        if device.type != "cuda":
            raise RuntimeError("communication='rdma' peer buffers live on "
                               f"the card, got device {device}")
        mine = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
        handles = [None] * P
        dist.all_gather_object(handles, reduce_tensor(mine), group=group)
        tensors = []
        for r, h in enumerate(handles):
            if r == rank:
                tensors.append(mine)
                continue
            try:
                t = _open_handle(h)
            except (RuntimeError, OSError) as err:
                raise RuntimeError(
                    f"communication='rdma': rank {rank} cannot open rank "
                    f"{r}'s buffer through CUDA IPC ({err}); the peer "
                    f"kernels need it, and rdma does not reroute") from err
            if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
                raise RuntimeError(f"rank {r}'s buffer is {tuple(t.shape)} "
                                   f"{t.dtype}, expected {tuple(shape)}")
            tensors.append(t)
        torch.cuda.synchronize(device)
        return cls(tensors, rank)


class PeerGroup:
    """A group's symmetric buffers, one per shape, created at first use (a
    collective of the group: every rank of it asks for the same shapes in
    the same order, as SPMD code does) and kept for the life of the
    plan."""

    def __init__(self, group, P: int, rank: int, device):
        self.group, self.P, self.rank = group, int(P), int(rank)
        self.device = torch.device(device)
        self._bufs = {}
        self.fence_seconds = 0.0    # host time spent in fence()

    def buffer(self, shape) -> SymmetricBuffer:
        shape = tuple(int(s) for s in shape)
        buf = self._bufs.get(shape)
        if buf is None:
            buf = self._bufs[shape] = SymmetricBuffer.exchange(
                self.group, self.P, self.rank, shape, self.device)
        return buf

    def fence(self) -> None:
        """Every rank's queued work done: stream synchronise, then the
        group barrier."""
        t0 = time.perf_counter()
        torch.cuda.current_stream(self.device).synchronize()
        dist.barrier(group=self.group)
        self.fence_seconds += time.perf_counter() - t0

    def planes(self, shape):
        """(re, im) views of this rank's symmetric buffer (2, C, a, b, c)
        for a planar pair of ``shape`` (…, a, b, c): where a forward's
        stage before rows 24/26 writes, and where rows 25/27 land."""
        C = math.prod(shape[:-3])
        mine = self.buffer((2, C) + tuple(shape[-3:])).mine()
        return mine[0].view(shape), mine[1].view(shape)


# -- launches ------------------------------------------------------------------

def _launch(name: str, fn_name: str, *args, device) -> None:
    from ..ops import _build
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(_build.load(), fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1


def _on_cpu(*ts) -> bool:
    """Validates float32 contiguous tensors on one device; True on the
    CPU (the twin runs), False on CUDA (the kernel launches)."""
    devs = {t.device for t in ts}
    if len(devs) != 1 or next(iter(devs)).type not in ("cpu", "cuda"):
        raise ValueError(f"tensors must all lie on the CPU or on one CUDA "
                         f"device, got {sorted(str(d) for d in devs)}")
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"peer kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("peer kernels take contiguous tensors")
    return next(iter(devs)).type == "cpu"


def _check_buf(buf: SymmetricBuffer, my: int, shape) -> None:
    if not 0 <= my < buf.P:
        raise ValueError(f"rank {my} outside a table of {buf.P}")
    for t in buf.tensors:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"buffer of shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")


# -- row 23: the tiled all-to-all --------------------------------------------------

def _a2a_out_shape(shape, P, split_axis, concat_axis):
    s = list(shape)
    if split_axis == concat_axis or s[split_axis] % P:
        raise ValueError(f"all-to-all of {tuple(shape)}: split axis "
                         f"{split_axis} (divisible by {P}) and concat axis "
                         f"{concat_axis} must differ")
    s[split_axis] //= P
    s[concat_axis] *= P
    return tuple(s)


def a2a_push_ref(x, buf, my, split_axis, concat_axis, leaf: int = 0):
    """Block d of ``x`` along ``split_axis`` into slot ``my`` of
    ``buf.tensors[d][leaf]`` along ``concat_axis``."""
    P = buf.P
    nc = x.shape[concat_axis]
    for d, blk in enumerate(torch.chunk(x, P, dim=split_axis)):
        buf.tensors[d][leaf].narrow(concat_axis, my * nc, nc).copy_(blk)


def a2a_push(x, buf: SymmetricBuffer, my: int, split_axis: int,
             concat_axis: int, leaf: int = 0) -> None:
    """Row 23 as rank ``my`` of ``buf``'s table: push block d of ``x``
    (float32, split axis divisible by P) into slot ``my`` of rank d's
    buffer (L, *out_shape), at ``[leaf]``; the buffers then hold
    ``lax.all_to_all(x, split_axis, concat_axis, tiled=True)``."""
    split_axis %= x.ndim
    concat_axis %= x.ndim
    out = _a2a_out_shape(x.shape, buf.P, split_axis, concat_axis)
    L = buf.tensors[0].shape[0]
    _check_buf(buf, my, (L,) + out)
    if not 0 <= leaf < L:
        raise ValueError(f"leaf {leaf} outside {L}")
    if _on_cpu(x, *buf.tensors):
        return a2a_push_ref(x, buf, my, split_axis, concat_axis, leaf)
    a, c = sorted((split_axis, concat_axis))
    s = x.shape
    _launch("peer_a2a", "peer_a2a_launch", x.data_ptr(),
            buf.table().data_ptr(), leaf * math.prod(out), buf.P, my,
            math.prod(s[:a]), s[split_axis], math.prod(s[a + 1:c]),
            s[concat_axis], math.prod(s[c + 1:]),
            int(split_axis < concat_axis), device=x.device)


# -- rows 24-25: the transpose fused with the x c2c --------------------------------

def _x_geometry(buf, my, C, n0, n1, h):
    P = buf.P
    if n0 % P or n1 % P:
        raise ValueError(f"(N0, N1) = ({n0}, {n1}) not divisible by {P}")
    if not p3.supported_c2c(n0):
        raise ValueError(f"N0={n0} outside the kernel envelope")
    _check_buf(buf, my, (2, C, n0 // P, n1, h))


def fft_x_pull_ref(buf, my: int):
    """The gathered x-lines of rank ``my``'s k1 slab from every buffer
    (2, C, Np0, N1, h), forward x c2c: a (2, C, N0, Np1, h) tensor."""
    P = buf.P
    np1 = buf.tensors[0].shape[3] // P
    g = torch.cat([t[:, :, :, my * np1:(my + 1) * np1] for t in buf.tensors],
                  dim=2)
    return torch.stack(p3.fft_axis_planar_ref(g[0].contiguous(),
                                              g[1].contiguous(), axis=1))


def fft_x_pull(buf: SymmetricBuffer, my: int) -> torch.Tensor:
    """Row 24 as rank ``my``: every buffer holds a rank's zy-transformed
    pair (2, C, Np0, N1, h); returns rank ``my``'s (2, C, N0, Np1, h) with
    the x axis transformed."""
    _, C, np0, n1, h = buf.tensors[0].shape
    n0 = np0 * buf.P
    _x_geometry(buf, my, C, n0, n1, h)
    if _on_cpu(*buf.tensors):
        return fft_x_pull_ref(buf, my)
    dev = buf.tensors[0].device
    out = torch.empty((2, C, n0, n1 // buf.P, h), dtype=torch.float32,
                      device=dev)
    _launch("peer_fft_x", "peer_fft_x_pull_launch", buf.table().data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(),
            p3._twiddles(n0, n0, -1, dev).data_ptr(), n0, n1, h, buf.P, my,
            C, device=dev)
    return out


def ifft_x_push_ref(xr, xi, buf, my: int) -> None:
    yr, yi = p3.fft_axis_planar_ref(xr, xi, axis=1, inverse=True)
    P = buf.P
    np0, np1 = xr.shape[1] // P, xr.shape[2]
    for d, t in enumerate(buf.tensors):
        rows = slice(d * np0, (d + 1) * np0)
        t[0, :, :, my * np1:(my + 1) * np1] = yr[:, rows]
        t[1, :, :, my * np1:(my + 1) * np1] = yi[:, rows]


def ifft_x_push(xr, xi, buf: SymmetricBuffer, my: int) -> None:
    """Row 25 as rank ``my``: the inverse x c2c (1/N0) of rank ``my``'s
    spectrum (C, N0, Np1, h), rows d·Np0… stored into rank d's buffer
    (2, C, Np0, N1, h) at k1 = my·Np1…"""
    if xr.shape != xi.shape or xr.ndim != 4:
        raise ValueError(f"ifft_x_push takes a (C, N0, Np1, h) pair, got "
                         f"{tuple(xr.shape)}, {tuple(xi.shape)}")
    C, n0, np1, h = xr.shape
    _x_geometry(buf, my, C, n0, np1 * buf.P, h)
    if _on_cpu(xr, xi, *buf.tensors):
        return ifft_x_push_ref(xr, xi, buf, my)
    _launch("peer_ifft_x", "peer_ifft_x_push_launch", buf.table().data_ptr(),
            xr.data_ptr(), xi.data_ptr(),
            p3._twiddles(n0, n0, 1, xr.device).data_ptr(), n0, np1 * buf.P,
            h, buf.P, my, C, device=xr.device)


# -- rows 26-27: the pencil's P2 transpose fused with the y c2c --------------------

def _y_geometry(buf, my, C, n0, n1, W):
    P = buf.P
    if W % P or n1 % P:
        raise ValueError(f"(N1, W) = ({n1}, {W}) not divisible by {P}")
    if not p3.supported_c2c(n1):
        raise ValueError(f"N1={n1} outside the kernel envelope")
    _check_buf(buf, my, (2, C, n0, n1 // P, W))


def fft_y_pull_ref(buf, my: int):
    """Rank ``my``'s lane block of every buffer (2, C, n0, N1/P, W),
    concatenated along y and y-transformed: a (2, C, n0, N1, W/P)
    tensor."""
    w2 = buf.tensors[0].shape[-1] // buf.P
    g = torch.cat([t[..., my * w2:(my + 1) * w2] for t in buf.tensors],
                  dim=3)
    return torch.stack(p3.fft_axis_planar_ref(g[0].contiguous(),
                                              g[1].contiguous(), axis=2))


def fft_y_pull(buf: SymmetricBuffer, my: int, out=None) -> torch.Tensor:
    """Row 26 as rank ``my``: every buffer holds a rank's z-transformed
    pair (2, C, n0, N1/P, W), W = P·w2 lanes; returns rank ``my``'s
    (2, C, n0, N1, w2): its lane block [my·w2, (my+1)·w2) of every peer,
    the peers' rows in rank order along y, y transformed.  ``out``: a
    contiguous (re, im) pair of the result's planes to write into (the
    buffer of the x stage that follows); the result is then their stack's
    view, or a new tensor on the CPU."""
    _, C, n0, n1loc, W = buf.tensors[0].shape
    n1 = n1loc * buf.P
    _y_geometry(buf, my, C, n0, n1, W)
    shape = (C, n0, n1, W // buf.P)
    if out is not None and any(tuple(o.shape) != shape or
                               not o.is_contiguous() for o in out):
        raise ValueError(f"fft_y_pull: out must be a contiguous pair of "
                         f"shape {shape}")
    if _on_cpu(*buf.tensors):
        y = fft_y_pull_ref(buf, my)
        if out is not None:
            out[0].copy_(y[0])
            out[1].copy_(y[1])
        return y
    dev = buf.tensors[0].device
    if out is None:
        y = torch.empty((2,) + shape, dtype=torch.float32, device=dev)
        out = (y[0], y[1])
    else:
        y = None
    _launch("peer_fft_y", "peer_fft_y_pull_launch", buf.table().data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(),
            p3._twiddles(n1, n1, -1, dev).data_ptr(), n1, W, buf.P, my,
            C * n0, device=dev)
    return y if y is not None else out


def ifft_y_push_ref(xr, xi, buf, my: int) -> None:
    yr, yi = p3.fft_axis_planar_ref(xr, xi, axis=2, inverse=True)
    P = buf.P
    n1loc, w2 = xr.shape[2] // P, xr.shape[3]
    for d, t in enumerate(buf.tensors):
        rows = slice(d * n1loc, (d + 1) * n1loc)
        t[0, ..., my * w2:(my + 1) * w2] = yr[:, :, rows]
        t[1, ..., my * w2:(my + 1) * w2] = yi[:, :, rows]


def ifft_y_push(xr, xi, buf: SymmetricBuffer, my: int) -> None:
    """Row 27 as rank ``my``: the inverse y c2c (1/N1) of rank ``my``'s
    spectrum (C, n0, N1, w2), rows d·N1/P… stored into rank d's buffer
    (2, C, n0, N1/P, P·w2) at lanes my·w2…"""
    if xr.shape != xi.shape or xr.ndim != 4:
        raise ValueError(f"ifft_y_push takes a (C, n0, N1, w2) pair, got "
                         f"{tuple(xr.shape)}, {tuple(xi.shape)}")
    C, n0, n1, w2 = xr.shape
    _y_geometry(buf, my, C, n0, n1, w2 * buf.P)
    if _on_cpu(xr, xi, *buf.tensors):
        return ifft_y_push_ref(xr, xi, buf, my)
    _launch("peer_ifft_y", "peer_ifft_y_push_launch", buf.table().data_ptr(),
            xr.data_ptr(), xi.data_ptr(),
            p3._twiddles(n1, n1, 1, xr.device).data_ptr(), n1, w2 * buf.P,
            buf.P, my, C * n0, device=xr.device)


# -- the group-level functions ("rdma" communication) -------------------

def _leaves(x):
    leaves = x if isinstance(x, tuple) else (x,)
    bad = [str(v.dtype) for v in leaves if not rdma_supported(v)]
    if bad:
        raise ValueError(
            f"communication='rdma' requires float32 arrays at the collective "
            f"(got {bad}): the kernel path carries planar pairs; complex "
            f"spectra (the torch.fft route, 'double') take another "
            f"communication=")
    return leaves


def rdma_all_to_all(x, peers: PeerGroup, split_axis: int, concat_axis: int):
    """``lax.all_to_all(x, split_axis, concat_axis, tiled=True)`` over the
    group, for a float32 tensor or a tuple of them: row 23 on the card
    (one launch a leaf between two fences), the group's
    ``all_to_all_single`` on the CPU."""
    leaves = _leaves(x)
    if leaves[0].device.type == "cpu":
        return collectives.transpose(x, peers.group, split_axis, concat_axis)
    nd = leaves[0].ndim
    split_axis, concat_axis = split_axis % nd, concat_axis % nd
    out = _a2a_out_shape(leaves[0].shape, peers.P, split_axis, concat_axis)
    buf = peers.buffer((len(leaves),) + out)
    peers.fence()
    for i, v in enumerate(leaves):
        a2a_push(v.contiguous(), buf, peers.rank, split_axis, concat_axis,
                 leaf=i)
    peers.fence()
    got = tuple(buf.mine().unbind(0))
    return got if isinstance(x, tuple) else got[0]


def rdma_all_gather(x, peers: PeerGroup, axis: int):
    """The tiled all-gather along ``axis``: on the card, row 23 on the
    block repeated P times (CUDA all-gather needs NCCL, one card a rank)."""
    leaves = _leaves(x)
    if leaves[0].device.type == "cpu":
        return collectives.all_gather(x, peers.group, axis)
    axis %= leaves[0].ndim
    rep = tuple(v.unsqueeze(0).expand((peers.P,) + tuple(v.shape))
                .contiguous() for v in leaves)
    got = rdma_all_to_all(rep, peers, 0, axis + 1)
    got = tuple(g.squeeze(0) for g in got)
    return got if isinstance(x, tuple) else got[0]


def fused_transpose_fft_x(yr, yi, peers: PeerGroup):
    """The slab forward's x stage: planar pair (…, Np0, N1, h) → (…, N0,
    Np1, h), transposed and x-transformed — row 24 on the card (the pair
    is copied into the symmetric buffer unless it is already the buffer's,
    ``peers.planes``), ``all_to_all_single`` + ``fft_axis_planar_ref``
    on the CPU."""
    _leaves((yr, yi))
    off = yr.ndim - 3
    if yr.device.type == "cpu":
        yr, yi = collectives.transpose((yr, yi), peers.group, 1 + off, off)
        return p3.fft_axis_planar_ref(yr, yi, axis=off)
    lead, (np0, n1, h) = tuple(yr.shape[:off]), tuple(yr.shape[off:])
    br, bi = peers.planes(yr.shape)
    if yr.data_ptr() != br.data_ptr() or yi.data_ptr() != bi.data_ptr():
        br.copy_(yr)
        bi.copy_(yi)
    buf = peers.buffer((2, math.prod(lead), np0, n1, h))
    peers.fence()
    out = fft_x_pull(buf, peers.rank)
    peers.fence()
    shape = lead + (np0 * peers.P, n1 // peers.P, h)
    return out[0].view(shape), out[1].view(shape)


def fused_ifft_x_transpose(yr, yi, peers: PeerGroup):
    """The slab backward's x stage: planar pair (…, N0, Np1, h) → (…, Np0,
    N1, h), inverse x-transformed (1/N0) and transposed — row 25 on the
    card, landing in this rank's symmetric buffer (a view, consumed by the
    zy inverse), ``fft_axis_planar_ref`` + ``all_to_all_single`` on the
    CPU."""
    _leaves((yr, yi))
    off = yr.ndim - 3
    if yr.device.type == "cpu":
        yr, yi = p3.fft_axis_planar_ref(yr, yi, axis=off, inverse=True)
        return collectives.transpose((yr, yi), peers.group, off, 1 + off)
    lead, (n0, np1, h) = tuple(yr.shape[:off]), tuple(yr.shape[off:])
    shape = lead + (n0 // peers.P, np1 * peers.P, h)
    C = math.prod(lead)
    buf = peers.buffer((2, C, n0 // peers.P, np1 * peers.P, h))
    peers.fence()
    ifft_x_push(yr.contiguous().view(C, n0, np1, h),
                yi.contiguous().view(C, n0, np1, h), buf, peers.rank)
    peers.fence()
    return peers.planes(shape)


def fused_transpose_fft_y(yr, yi, peers: PeerGroup, out=None):
    """The pencil forward's y stage over the P2 group: planar pair
    (…, n0, N1/P, W) → (…, n0, N1, W/P), split along the lanes, gathered
    along y and y-transformed — row 26 on the card (the pair is copied into
    the symmetric buffer unless it is already the buffer's,
    ``peers.planes``; ``out`` as for ``fft_y_pull``),
    ``all_to_all_single`` + ``fft_axis_planar_ref`` on the CPU."""
    _leaves((yr, yi))
    off = yr.ndim - 3
    if yr.device.type == "cpu":
        yr, yi = collectives.transpose((yr, yi), peers.group, 2 + off,
                                       1 + off)
        return p3.fft_axis_planar_ref(yr, yi, axis=1 + off)
    lead, (n0, n1loc, W) = tuple(yr.shape[:off]), tuple(yr.shape[off:])
    br, bi = peers.planes(yr.shape)
    if yr.data_ptr() != br.data_ptr() or yi.data_ptr() != bi.data_ptr():
        br.copy_(yr)
        bi.copy_(yi)
    C = math.prod(lead)
    buf = peers.buffer((2, C, n0, n1loc, W))
    shape = lead + (n0, n1loc * peers.P, W // peers.P)
    flat = (C, n0, n1loc * peers.P, W // peers.P)
    peers.fence()
    got = fft_y_pull(buf, peers.rank, None if out is None else
                     tuple(o.view(flat) for o in out))
    peers.fence()
    return got[0].view(shape), got[1].view(shape)


def fused_ifft_y_transpose(yr, yi, peers: PeerGroup):
    """The pencil backward's y stage over the P2 group: planar pair
    (…, n0, N1, w2) → (…, n0, N1/P, P·w2), inverse y-transformed (1/N1),
    split along y and gathered along the lanes — row 27 on the card,
    landing in this rank's symmetric buffer (a view, consumed by the z
    inverse), ``fft_axis_planar_ref`` + ``all_to_all_single`` on the
    CPU."""
    _leaves((yr, yi))
    off = yr.ndim - 3
    if yr.device.type == "cpu":
        yr, yi = p3.fft_axis_planar_ref(yr, yi, axis=1 + off, inverse=True)
        return collectives.transpose((yr, yi), peers.group, 1 + off, 2 + off)
    lead, (n0, n1, w2) = tuple(yr.shape[:off]), tuple(yr.shape[off:])
    shape = lead + (n0, n1 // peers.P, w2 * peers.P)
    C = math.prod(lead)
    buf = peers.buffer((2, C, n0, n1 // peers.P, w2 * peers.P))
    peers.fence()
    ifft_y_push(yr.contiguous().view(C, n0, n1, w2),
                yi.contiguous().view(C, n0, n1, w2), buf, peers.rank)
    peers.fence()
    return peers.planes(shape)
