"""Seconds a fit's host spends building and launching its family
batches, from the program's own span (``selector.dispatch``, one a
family batch): the host's share of ``sweep_s``, which also holds the
wait for the card at collect; a fit. None where the program records no
such span."""
from ..spans import seconds

from . import per_fit

#: frozen: the span this metric reads
SPAN = "selector.dispatch"


def read(run):
    t = seconds(run["trace"], SPAN)
    return None if t is None else per_fit(run, t)
