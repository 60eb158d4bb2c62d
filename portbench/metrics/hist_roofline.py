"""The histogram kernel's share of its roofline in the traced window:
the summed least time of every launch (``costs.histogram_bound_s`` at
the shape each launch was given) over the summed device time of the
kernel's passes (device events named ``tree_hist``), in percent. None
where nothing launched."""
from ..costs import histogram_bound_s
from . import HIST


def read(run):
    shapes = run["hist_shapes"]
    dev = run["trace"].device_time(lambda n: bool(HIST.search(n)))
    if not shapes or dev <= 0:
        return None
    return 100.0 * sum(histogram_bound_s(s) for s in shapes) / dev
