"""Seconds a fit the card idles while the host is inside the published
FT-Transformer's steps or scoring: device idle time in the traced window
whose innermost open program span is ``ft.*`` (a step, a block of
scoring), torch and CUDA runtime events passed over; a fit. None where
the program records no such span."""
from ..spans import PROGRAM_SPANS, idle_under

from . import per_fit

#: frozen: the spans this metric reads, split off from the regions
#: around them
MINE = frozenset(("ft.step", "ft.score"))


def read(run):
    t = idle_under(run["trace"], lambda n: n in MINE,
                   names=PROGRAM_SPANS | MINE)
    return None if t is None else per_fit(run, t)
