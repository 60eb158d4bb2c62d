"""Host milliseconds of one optimiser step of a published FT-Transformer
chunk (its batch, forward, backward and AdamW): the mean length of the
program's ``ft.step`` spans in the traced window, sweep and refit alike.
None where the program records no such span."""
from ..spans import spans

#: frozen: the span this metric reads
SPAN = "ft.step"


def read(run):
    iv = spans(run["trace"], SPAN)
    return 1e3 * float((iv[:, 1] - iv[:, 0]).mean()) if len(iv) else None
