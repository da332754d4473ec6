"""``transform_ms.step``: the self device time of the program's
``mpifft.transform.forward`` and ``.backward`` spans in the traced chunk,
per step, in ms: the 3D transforms' kernels and their own masks and
purifies, without the complex boundary (in the packed layout the fused
curl, cross product and projection too).  Read as ``integrator_ms.step``
is."""

METRIC = "transform_ms.step"
NAMES = ("mpifft.transform.forward", "mpifft.transform.backward")
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
