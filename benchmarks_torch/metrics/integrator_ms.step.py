"""``integrator_ms.step``: the self device time of the program's
``mpifft.solver.step`` spans in the traced chunk, per step, in ms: the
integrator's own combinations (RK4's ``U + c·k`` and accumulator updates),
outside every right-hand side.  Read from ``profiling.report()`` of
``mpifft4py_tpu_torch.utils.profiling``, whose spans record while the
profiler's active phase runs; divided by the count of step spans, with a
note where that count differs from the segment's units."""

METRIC = "integrator_ms.step"
NAMES = ("mpifft.solver.step",)
UNIT = "mpifft.solver.step"


def read(rec):
    if rec.segment is None:
        return None
    try:
        from mpifft4py_tpu_torch.utils import profiling
    except ImportError:             # a program without spans
        return None
    spans = profiling.report()
    units = spans.get(UNIT, {}).get("count")
    selfs = [spans[n]["self_device_s"] for n in NAMES if n in spans]
    if not units or not selfs or None in selfs:
        return None
    if units != rec.segment.units:
        rec.notes.append(f"{METRIC}: {units} {UNIT} spans against "
                         f"{rec.segment.units} traced units")
    return 1e3 * sum(selfs) / units
