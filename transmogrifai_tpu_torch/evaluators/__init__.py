"""Metric kernels of the port (``functional``); the evaluator stages of
``transmogrifai_tpu/evaluators/__init__.py`` are not ported yet."""
from . import functional

__all__ = ["functional"]
