"""``induction_ms.step``: the inclusive device time of the program's
``mpifft.solver.induction`` spans in the traced chunk, per step, in ms: an
MHD right-hand side's induction half, i K × F̂(u × b) − η k² b̂ (in the
packed layout the cross kernel with the z/y forwards and the curl
epilogue), one span a right-hand side.  A program without the span gives
nothing."""

from span_reader import inclusive_ms_per_step


def read(rec):
    return inclusive_ms_per_step(rec, "induction_ms.step",
                                 "mpifft.solver.induction")
