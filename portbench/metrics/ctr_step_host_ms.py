"""Host milliseconds of one minibatch update of a CTR fit: the mean
length of the program's ``sparse.step`` spans in the traced window (the
sweep's and the refit's steps alike). None where the program records no
such span."""
from ..spans import spans

#: frozen: the span this metric reads
SPAN = "sparse.step"


def read(run):
    iv = spans(run["trace"], SPAN)
    return 1e3 * float((iv[:, 1] - iv[:, 0]).mean()) if len(iv) else None
