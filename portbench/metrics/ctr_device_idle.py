"""The device's idle share of a CTR fit's traced window (as
``device_idle``)."""
from .device_idle import read  # noqa: F401  (the same arithmetic)
