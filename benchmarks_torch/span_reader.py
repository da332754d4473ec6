"""The per-step reading of one of the program's spans, for the readers
of spans that a right-hand side opens once (``metrics/momentum_ms.step``,
``metrics/induction_ms.step``).  The spans' totals come from
``profiling.report()`` of ``mpifft4py_tpu_torch.utils.profiling``, which
records while the profiler's active phase runs."""

STEP, RHS = "mpifft.solver.step", "mpifft.solver.rhs"


def inclusive_ms_per_step(rec, metric, name):
    """The inclusive device time of the spans ``name`` in the traced chunk
    over the count of step spans, in ms; None without a segment, the
    spans or their device times (a program without them).  Notes where
    the step spans' count differs from the segment's units, or the spans'
    count from the right-hand sides'."""
    if rec.segment is None:
        return None
    try:
        from mpifft4py_tpu_torch.utils import profiling
    except ImportError:             # a program without spans
        return None
    spans = profiling.report()
    units = spans.get(STEP, {}).get("count")
    t = spans.get(name)
    if not units or t is None or t["device_s"] is None:
        return None
    if units != rec.segment.units:
        rec.notes.append(f"{metric}: {units} {STEP} spans against "
                         f"{rec.segment.units} traced units")
    rhs = spans.get(RHS, {}).get("count")
    if t["count"] != rhs:
        rec.notes.append(f"{metric}: {t['count']} {name} spans against "
                         f"{rhs} {RHS} spans")
    return 1e3 * t["device_s"] / units
