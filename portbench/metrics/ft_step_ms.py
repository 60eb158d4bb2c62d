"""Device milliseconds an FT item-step: the device time of every kernel
in the traced window (copies and sets left out; the scoring's forwards
and the selector's metrics included) over the item-steps the traced fits
took, read from the family's counter (a step of one real item). None
where the fits carry no counter."""
from . import MOVES


def read(run):
    steps = sum(f.get("ft", {}).get("item_steps", 0) for f in run["fits"])
    dev = run["trace"].device_time(lambda n: not MOVES.match(n))
    return 1e3 * dev / steps if dev > 0 and steps else None
