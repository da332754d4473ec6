"""``device_idle.step``: the share of the traced chunk of RK4 steps in
which no operation ran on the device, 1 − busy / window, in %."""

from traced import idle_percent


def read(rec):
    return idle_percent(rec)
