"""Seconds of a fit outside the family sweeps: the split, the copies to
the device, the winner's refit, its holdout metrics and the summary (the
fit's wall minus its families' walls); the mean over the window's
fits."""


def read(run):
    fits = run["fits"]
    return sum(f["wall_s"] - sum(f["families_s"].values())
               for f in fits) / len(fits)
