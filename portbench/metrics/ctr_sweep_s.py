"""Seconds a CTR selector fit spends in its family sweeps: the sum of
the fitted selector's ``wall_seconds["families"]`` (host clock, each
family's losses read back); the mean over the window's fits."""
from .sweep_s import read  # noqa: F401  (the same arithmetic)
