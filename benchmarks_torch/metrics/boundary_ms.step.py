"""``boundary_ms.step``: the self device time of the program's
``mpifft.transform.boundary`` spans in the traced chunk, per step, in ms:
the conversions between the planar float32 pair and complex64 and the 3/2
rule's pad/truncate.  Read as ``integrator_ms.step`` is."""

METRIC = "boundary_ms.step"
NAMES = ("mpifft.transform.boundary",)
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
