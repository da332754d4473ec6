"""Spans at the port's layer boundaries: which stage of a step or a
transform spends the host's and the device's time.

``span(name)`` is a context manager placed at the boundaries of the
solvers and the transforms (every name starts with ``mpifft.``):

* ``mpifft.solver.run`` — ``SpectralSolver.run``, the loop and the stack
  of the logged energies;
* ``mpifft.solver.step`` — one step; its self time is the integrator's own
  combinations (RK4's ``U + c·k`` and ``acc.add_``);
* ``mpifft.solver.rhs`` — one right-hand side; its self time is the
  pointwise work outside the transforms (curl, cross product, projection,
  viscous term, forcing);
* ``mpifft.solver.momentum`` / ``.induction`` — inside an MHD right-hand
  side, its two halves, each with its forward transform:
  P[F̂(u × ω + j × b)] − ν k² û and i K × F̂(u × b) − η k² b̂;
* ``mpifft.solver.monitor`` — the energy logged every k steps;
* ``mpifft.transform.forward`` / ``.backward`` — every call that runs a 3D
  transform: the slab's and the pencil's ``fftn``/``ifftn`` and field
  stacks, the packed interface, and the packed solvers' fused helpers (in
  the packed layout the curl, cross product and projection ride the
  transform kernels, so they fall here);
* ``mpifft.transform.boundary`` — inside a transform, the conversions
  between the planar float32 pair and complex64 (``unpack_spectrum``,
  ``pack_spectrum``) and the 3/2 rule's pad/truncate;
* ``mpifft.transform.exchange`` — inside a transform at P > 1, each
  collective of ``parallel.collectives`` (``transpose`` with its send
  buffer's copy and the received blocks' merge, ``transpose_pipelined``'s
  posts and waits, ``all_gather``); at P == 1 none opens.  Its device time
  is the time the calling stream waits for the exchange.

Beside its times a span may count bytes (``add_bytes``): each exchange
adds the bytes that leave this rank, the P − 1 blocks it sends, and
``report()`` gives their total as the name's ``"bytes"``.

A span records only while tracing is on: between ``enable()`` and
``disable()``, or while a ``torch.profiler`` session records (its active
phase).  Off, ``span`` returns one shared no-op context, at the cost of a
flag read and a call.  On, a span

* enters ``torch.profiler.record_function(name)``, so it shows in a
  profiler's trace beside the device kernels, on their clock (and as an
  NVTX range under ``torch.autograd.profiler.emit_nvtx()``);
* reads ``time.perf_counter()`` at its ends;
* records a CUDA event on the current stream at its ends, once CUDA is
  initialised (events come from a pool; nothing synchronises).

A span's parent is the innermost span open when it starts.  Self time is a
span's time less the part of it its direct children cover.  Records fold
into per-name totals as their events complete: each root span's exit
checks the finished roots without blocking, and ``report()`` folds what
is left after one synchronise, so a long run keeps a bounded number of
events alive.  Spans are those of one thread: the port steps from one.

Two uses:

    from mpifft4py_tpu_torch.utils import profiling
    profiling.enable()
    state = solver.run(U, 10)
    profiling.disable()
    for name, t in profiling.report().items():   # a table, no profiler
        print(name, t["count"], t["self_device_s"])

or any ``torch.profiler.profile(...)`` session, whose trace shows the
``mpifft.`` spans (``user_annotation``) above the kernels they issue.
"""

from __future__ import annotations

import time

import torch

__all__ = ["span", "enable", "disable", "report", "reset"]

_enabled = False


class _Off:
    """The shared context of a span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Totals:
    __slots__ = ("count", "host_s", "self_host_s", "device_s",
                 "self_device_s", "bytes")

    def __init__(self):
        self.count, self.host_s, self.self_host_s = 0, 0.0, 0.0
        self.device_s = self.self_device_s = self.bytes = None

    def as_dict(self):
        """The totals; ``"bytes"`` only where a span of the name counted
        bytes."""
        return {k: getattr(self, k) for k in self.__slots__
                if k != "bytes" or self.bytes is not None}


class _Recorder:
    """The open spans, the finished roots whose events have not completed,
    the per-name totals and the pool of CUDA events."""

    def __init__(self):
        self.stack = []
        self.pending = []          # (end event, spans of one root tree)
        self.totals = {}
        self.pool = []

    def event(self):
        return (self.pool.pop() if self.pool
                else torch.cuda.Event(enable_timing=True))

    def total(self, name):
        t = self.totals.get(name)
        if t is None:
            t = self.totals[name] = _Totals()
        return t

    def fold(self, block: bool):
        """Fold the device times of the finished roots, oldest first, up
        to the first whose end event has not completed (all of them, after
        one synchronise, with ``block``)."""
        if block and self.pending:
            self.pending[-1][0].synchronize()
        done = 0
        for end, tree in self.pending:
            if not end.query():
                break
            for s in tree:               # children before their parents
                d = s.ev0.elapsed_time(s.ev1) * 1e-3
                t = self.total(s.name)
                if t.device_s is None:
                    t.device_s = t.self_device_s = 0.0
                t.device_s += d
                t.self_device_s += d - s.child_dev
                if s.parent is not None:
                    s.parent.child_dev += d
                self.pool += (s.ev0, s.ev1)
            done += 1
        del self.pending[:done]


_rec = _Recorder()


class _Span:
    __slots__ = ("name", "parent", "root", "tree", "rf", "t0", "child_host",
                 "ev0", "ev1", "child_dev", "nbytes")

    def __init__(self, name):
        self.name = name
        self.nbytes = None

    def add_bytes(self, n: int) -> None:
        """Count ``n`` bytes to this span (the name's ``"bytes"``)."""
        self.nbytes = (self.nbytes or 0) + int(n)

    def __enter__(self):
        st = _rec.stack
        self.parent = st[-1] if st else None
        self.root = self if self.parent is None else self.parent.root
        self.tree = [] if self.parent is None else None
        self.child_host = self.child_dev = 0.0
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.ev0 = self.ev1 = None
        if torch.cuda.is_initialized():
            self.ev0 = _rec.event()
            self.ev0.record()
        st.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        _rec.stack.pop()
        if self.ev0 is not None:
            self.ev1 = _rec.event()
            self.ev1.record()
            self.root.tree.append(self)
        self.rf.__exit__(*exc)
        t = _rec.total(self.name)
        t.count += 1
        t.host_s += dur
        t.self_host_s += dur - self.child_host
        if self.nbytes is not None:
            t.bytes = (t.bytes or 0) + self.nbytes
        if self.parent is not None:
            self.parent.child_host += dur
        elif self.tree:
            _rec.pending.append((self.tree[-1].ev1, self.tree))
            _rec.fold(block=False)
        return False


def span(name: str):
    """A context that records the span ``name`` while tracing is on (see
    the module's docstring), and the shared no-op context otherwise.  It
    enters as the span (``add_bytes`` counts bytes to it) when on, as None
    when off."""
    if not (_enabled or torch.autograd._profiler_enabled()):
        return _OFF
    return _Span(name)


def enable() -> None:
    """Record spans until ``disable()``, with or without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def report() -> dict:
    """{name: {"count", "host_s", "self_host_s", "device_s",
    "self_device_s"[, "bytes"]}} of the spans that have ended since the
    last ``reset()``, in seconds; the device fields are None where no span
    of the name recorded CUDA events (the CPU); ``"bytes"`` is there where
    a span of the name counted bytes.  Synchronises once on the last
    recorded event."""
    _rec.fold(block=True)
    return {name: t.as_dict() for name, t in _rec.totals.items()}


def reset() -> None:
    """Clear the totals, and drop the records still in flight and the
    pooled events."""
    _rec.pending.clear()
    _rec.totals.clear()
    _rec.pool.clear()
