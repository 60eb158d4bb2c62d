"""Seconds a fit the card idles while the host is inside the tree
engine: device idle time in the traced window whose innermost open
program span is one of the tree engine's (``trees.*``: binning, a
boosting round, a level, the leaf sums), torch and CUDA runtime events
passed over; a fit. None where the program records no such span."""
from ..spans import idle_under

from . import per_fit

#: frozen: the spans this metric reads
PREFIX = "trees."


def read(run):
    t = idle_under(run["trace"], lambda n: n.startswith(PREFIX))
    return None if t is None else per_fit(run, t)
