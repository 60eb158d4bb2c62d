"""The fitted-stage protocol of the ported device chain.

Counterpart of ``transmogrifai_tpu/stages/base.py`` cut to what serving
needs: a fitted stage knows its input column names, its output column
name, its fitted ``params``, and builds its device function
(``make_device_fn``) — a plain function on tensors that lie on the
stage's device. Fitting stays with the JAX package in this slice; the
port's stages come from a portable artifact (``portable.from_portable``).
"""
from __future__ import annotations

from typing import Callable, Sequence


class Transformer:
    """A fitted device stage: ``input_names`` -> ``output_name``."""

    def __init__(self, input_names: Sequence[str], output_name: str,
                 **params):
        self.input_names = list(input_names)
        self.output_name = str(output_name)
        self.params = params

    def make_device_fn(self) -> Callable:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.output_name!r})"
