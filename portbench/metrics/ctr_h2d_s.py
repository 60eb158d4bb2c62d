"""Device seconds a CTR fit spends copying from the host to the card
(``io/stream.py``'s prefetch of each chunk, and every other host-to-device
copy) in the traced window, per fit."""
from . import per_fit


def read(run):
    t = run["trace"].device_time(lambda n: n.startswith("Memcpy HtoD"))
    return per_fit(run, t) if t > 0 else None
