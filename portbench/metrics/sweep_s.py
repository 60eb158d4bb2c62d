"""Seconds a fit spends validating its candidate families: the sum of
the fitted selector's ``wall_seconds["families"]``, each family batch's
host-clock wall ending in a copy to the host; the mean over the
window's fits."""


def read(run):
    fits = run["fits"]
    return sum(sum(f["families_s"].values()) for f in fits) / len(fits)
