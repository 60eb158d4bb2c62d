"""Histogram kernel launches a fit, from the program's own counter
(``kernels.histogram_grid.launches``); the mean over the window's fits.
None where no fit launched it."""


def read(run):
    n = sum(f["hist_launches"] for f in run["fits"])
    return n / len(run["fits"]) if n else None
