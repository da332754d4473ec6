"""``momentum_ms.step``: the inclusive device time of the program's
``mpifft.solver.momentum`` spans in the traced chunk, per step, in ms: an
MHD right-hand side's momentum half, P[F̂(u × ω + j × b)] − ν k² û (in the
packed layout the cross2 kernel with the z/y forwards and the projection
epilogue), one span a right-hand side.  A program without the span gives
nothing."""

from span_reader import inclusive_ms_per_step


def read(rec):
    return inclusive_ms_per_step(rec, "momentum_ms.step",
                                 "mpifft.solver.momentum")
