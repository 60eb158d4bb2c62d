"""Seconds a CTR fit's consuming thread spends in ``io/stream.py``:
staging chunks (``stream.stage``: pinning a chunk and queueing its
copies) and waiting on the host-prefetch queue (``stream.wait``), from
the program's own spans; a fit. None where the program records
neither."""
from ..spans import seconds

from . import per_fit

#: frozen: the spans this metric reads
SPANS = ("stream.stage", "stream.wait")


def read(run):
    t = seconds(run["trace"], SPANS)
    return None if t is None else per_fit(run, t)
