"""Device functions of the numeric vectorizers.

Counterparts of ``transmogrifai_tpu/ops/vectorizers.py``:
:func:`impute_device_fn` is ``_impute_device_fn`` (impute + optional
null-indicator track, shared by the Real and Binary vectorizers) and
:class:`VectorsCombiner` is the concat device function. Both are
selection-only (isnan / where / stack / cat), so they match the JAX
device functions bitwise in f32.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..stages.base import Transformer


def impute_device_fn(fill: float, track: bool) -> Callable:
    """Shared device impute+indicator closure (Real & Binary vectorizers)."""

    def fn(col):
        col = col.to(torch.float32)
        isnull = torch.isnan(col)
        filled = torch.where(isnull, float(fill), col)
        if track:
            return torch.stack([filled, isnull.to(torch.float32)], dim=1)
        return filled[:, None]

    return fn


class RealVectorizerModel(Transformer):
    """Fitted impute stage (portable op ``impute``): one numeric column
    -> [filled value, null indicator] (or [filled value])."""

    def __init__(self, input_names, output_name, *, fill_value: float,
                 track_nulls: bool = True):
        super().__init__(input_names, output_name,
                         fill_value=float(fill_value),
                         track_nulls=bool(track_nulls))

    def make_device_fn(self) -> Callable:
        return impute_device_fn(self.params["fill_value"],
                                self.params["track_nulls"])


class VectorsCombiner(Transformer):
    """Concatenate vector blocks along the feature axis (portable op
    ``concat``)."""

    def make_device_fn(self) -> Callable:
        def fn(*blocks):
            return torch.cat([b.to(torch.float32) for b in blocks], dim=1)

        return fn
