"""Device milliseconds a minibatch step: the device time of every kernel
(copies and sets left out) in the traced window over the steps the
traced fits took (each family's epochs of batches, the refit's epochs;
batches from the training rows and the batch size)."""
from . import MOVES


def read(run):
    tr = run["trace"]
    dev = tr.device_time(lambda n: not MOVES.match(n))
    steps = 0
    for f in run["fits"]:
        st = f["stream"]
        per = -(-f["n_train"] // st["batch_size"])
        fams = {r["family"] for r in f["summary"]["validationResults"]}
        steps += per * (len(fams) * st["epochs"] + st["refit_epochs"])
    return 1e3 * dev / steps if dev > 0 and steps else None
