"""``device_idle.roundtrip``: as ``device_idle.step``, over the traced
chunk of round trips."""

from traced import idle_percent


def read(rec):
    return idle_percent(rec)
