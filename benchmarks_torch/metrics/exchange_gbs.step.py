"""``exchange_gbs.step``: the bytes that left this rank in the traced
chunk's exchanges (the counter of the ``mpifft.transform.exchange`` spans:
(P − 1)/P of each transpose's send buffer, P − 1 copies of each gathered
block) over those spans' self device time, in GB/s.  An effective rate of
the exchange as the step sees it, copies and merges included, not a share
of a link's peak.  Per step or in all, the ratio is the same; a program
without the span or its counter gives nothing."""

NAME = "mpifft.transform.exchange"


def read(rec):
    if rec.segment is None:
        return None
    try:
        from mpifft4py_tpu_torch.utils import profiling
    except ImportError:             # a program without spans
        return None
    ex = profiling.report().get(NAME)
    if ex is None or not ex.get("bytes") or not ex["self_device_s"]:
        return None
    return ex["bytes"] / ex["self_device_s"] / 1e9
