"""The fitted model stage and the model-family registry of the port.

Counterpart of ``transmogrifai_tpu/models/base.py`` cut to serving:
:class:`PredictionModel` carries the family name, the class count and
the fitted parameters (tensors on the scoring device) and builds the
device function ``fn(label, X)`` the fused scorer runs. Families
register their predict function by name (:func:`register_family`,
used by ``models/linear.py``); a family the port has no predict for
raises, naming it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..stages.base import Transformer

#: family name -> predict(params, X, n_classes)
MODEL_FAMILIES: Dict[str, Callable] = {}


def register_family(name: str):
    def deco(fn: Callable) -> Callable:
        MODEL_FAMILIES[name] = fn
        return fn
    return deco


class PredictionModel(Transformer):
    """Fitted model stage: (label, features) -> (n, k) probabilities or
    (n, 1) predictions. ``params`` holds ``family``, ``problem`` and
    ``n_classes`` as in the JAX package; ``model_params`` the fitted
    tensors (on the scoring device)."""

    def __init__(self, input_names, output_name, *, family: str,
                 n_classes: int = 2, problem: Optional[str] = None,
                 model_params: Optional[Dict[str, torch.Tensor]] = None):
        if family not in MODEL_FAMILIES:
            raise ValueError(
                f"model family {family!r} is not ported (have "
                f"{sorted(MODEL_FAMILIES)})")
        super().__init__(input_names, output_name, family=family,
                         problem=problem, n_classes=int(n_classes))
        self.model_params = dict(model_params or {})

    def make_device_fn(self) -> Callable:
        params = self.model_params
        predict = MODEL_FAMILIES[self.params["family"]]
        n_classes = self.params["n_classes"]

        def fn(label, X):  # label (response) unused at transform time
            return predict(params, X.to(torch.float32), n_classes)

        return fn
