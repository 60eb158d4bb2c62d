"""Seconds a fit spends in the selector's split, from the program's own
span (``selector.split``: the column reads, the train/holdout split, the
balancing weights and the copy of the training rows on the host), a
fit; None where the program records no such span."""
from ..spans import seconds

from . import per_fit

#: frozen: the span this metric reads
SPAN = "selector.split"


def read(run):
    t = seconds(run["trace"], SPAN)
    return None if t is None else per_fit(run, t)
