"""Seconds a fit the card idles while the host is inside the linear
solvers: device idle time in the traced window whose innermost open
program span is a solver's (``linear.*``: a solve, one of its
iterations), torch and CUDA runtime events passed over; a fit. None
where the program records no such span."""
from ..spans import idle_under

from . import per_fit

#: frozen: the spans this metric reads
PREFIX = "linear."


def read(run):
    t = idle_under(run["trace"], lambda n: n.startswith(PREFIX))
    return None if t is None else per_fit(run, t)
