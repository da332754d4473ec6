"""``exchange_ms.step``: the self device time of the program's
``mpifft.transform.exchange`` spans in the traced chunk, per step, in ms:
the time the transforms' stream waits on the collectives of the slab at
P > 1 (the all-to-all transposes and the plane-0 all-gathers over NCCL),
with the send buffers' copies and the received blocks' merges.  Read as
``transform_ms.step`` is; a program without the span gives nothing."""

METRIC = "exchange_ms.step"
NAMES = ("mpifft.transform.exchange",)
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
