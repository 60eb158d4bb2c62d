"""Device function of the fitted SanityChecker.

Counterpart of ``SanityCheckerModel.make_device_fn`` in
``transmogrifai_tpu/ops/sanity_checker.py``: keep the columns the
checker retained (portable op ``keep_cols``), a pure gather.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..stages.base import Transformer


class SanityCheckerModel(Transformer):
    """``keep_indices`` is an int64 tensor on the scoring device."""

    def __init__(self, input_names, output_name, *,
                 keep_indices: torch.Tensor):
        super().__init__(input_names, output_name,
                         keep_indices=keep_indices.to(torch.int64))

    def make_device_fn(self) -> Callable:
        keep = self.params["keep_indices"]

        def fn(label, vec):  # label unused at transform time
            return vec.index_select(1, keep).to(torch.float32)

        return fn
