"""ModelSelector: the AutoML heart.

Counterpart of ``transmogrifai_tpu/models/selector.py`` (reference:
selector/ — ModelSelector, SelectedModel, the three factories). Flow:
the splitter prepares data (balance/cut) and reserves a holdout; the
validator cross-validates every candidate (family x hyper grid); the
best (family, hyper) refits on the full training split; train and
holdout metrics and the whole validation grid go into the summary
carried by the fitted SelectedModel.

The JAX selector's ``mesh`` is a ``device`` here, resolved by
``_device.resolve_device`` at fit time (CUDA unless the caller asks for
the CPU). Candidates must validate on the folded path (the tree
families in this slice): another family raises at construction, naming
it. Not carried over: the family-level fit checkpoint (resume) and the
static-hyper refit specialization (tree families have no static
hypers). The summary adds ``wallSeconds``: each family batch's wall
and the refit's, host clock, each ending in a copy to the host.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..dataset import Dataset
from ..evaluators import functional as F
from ..features import types as ft
from ..profiling import check_finite
from ..stages.base import BinaryEstimator
from .base import MODEL_FAMILIES, PredictionModel, params_to_numpy
from .tuning import (OpCrossValidation, OpTrainValidationSplit, OpValidator,
                     RANDOM_SEED, ValidationResult, make_splitter,
                     require_folded)

_DEFAULT_METRIC = {"binary": "auroc", "multiclass": "error",
                   "regression": "rmse"}


class SelectedModel(PredictionModel):
    """Fitted best model + ModelSelectorSummary."""
    operation_name = "modelSelected"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.summary: Dict[str, Any] = {}


def _full_metrics(problem: str, probs: torch.Tensor, y: torch.Tensor
                  ) -> Dict[str, float]:
    if problem == "binary":
        m = F.binary_metrics(probs[:, 1], y)
    elif problem == "multiclass":
        m = F.multiclass_metrics(probs, y.to(torch.int64))
        m = {k: v for k, v in m.items() if k != "confusion"}
    else:
        m = F.regression_metrics(probs[:, 0], y)
    return {k: float(v) for k, v in m.items()}


class ModelSelector(BinaryEstimator):
    """(label, features) -> Prediction from the best validated model."""
    in_types = (ft.RealNN, ft.OPVector)
    out_type = ft.Prediction
    operation_name = "modelSelected"
    model_cls = SelectedModel

    def __init__(self, problem: str = "binary",
                 validation: Optional[Dict[str, Any]] = None,
                 splitter: Optional[Dict[str, Any]] = None,
                 candidates: Optional[List] = None,
                 seed: int = RANDOM_SEED, uid=None, device=None, **kw):
        if problem not in ("binary", "multiclass", "regression"):
            raise ValueError(f"unknown problem type {problem!r}")
        validation = validation or {"type": "crossValidation", "folds": 3,
                                    "metric": _DEFAULT_METRIC[problem]}
        if candidates is None:
            candidates = self.default_candidates(problem)
        candidates = [[c, None] if isinstance(c, str) else list(c)
                      for c in candidates]
        for name, _ in candidates:
            if name not in MODEL_FAMILIES:
                raise ValueError(f"unknown model family {name!r}; known: "
                                 f"{sorted(MODEL_FAMILIES)}")
            require_folded(MODEL_FAMILIES[name])
        super().__init__(uid=uid, problem=problem, validation=validation,
                         splitter=splitter or {}, candidates=candidates,
                         seed=seed, **kw)
        #: where the fit runs (transient, not persisted): None resolves
        #: to CUDA at fit time, raising without a card
        self.device = device

    @staticmethod
    def default_candidates(problem: str) -> List[str]:
        return sorted(name for name, fam in MODEL_FAMILIES.items()
                      if problem in fam.problem_types
                      and fam.in_default_candidates)

    def _make_validator(self) -> OpValidator:
        v = dict(self.params["validation"])
        metric = v.get("metric", _DEFAULT_METRIC[self.params["problem"]])
        if v.get("type", "crossValidation") == "crossValidation":
            return OpCrossValidation(n_folds=int(v.get("folds", 3)),
                                     metric=metric, seed=self.params["seed"])
        return OpTrainValidationSplit(
            train_ratio=float(v.get("trainRatio", 0.75)), metric=metric,
            seed=self.params["seed"])

    def _make_splitter(self):
        problem = self.params["problem"]
        return make_splitter(
            self.params["splitter"], self.params["seed"],
            default_kind={"binary": "balancer", "multiclass": "cutter",
                          "regression": "splitter"}[problem])

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        label_name, vec_name = self.input_names
        problem = self.params["problem"]
        dev = resolve_device(self.device)
        X = ds.column(vec_name).astype(np.float32)
        y = ds.column(label_name).astype(np.float32)
        n = len(y)
        if problem == "binary":
            n_classes = 2
        elif problem == "multiclass":
            n_classes = int(y.max()) + 1
        else:
            n_classes = 1

        splitter = self._make_splitter()
        train_idx, hold_idx = splitter.split(n)
        X_tr, y_tr = X[train_idx], y[train_idx]
        base_w, splitter_summary = splitter.prepare(y_tr)

        validator = self._make_validator()
        entries = []
        for ci, (name, overrides) in enumerate(self.params["candidates"]):
            fam = MODEL_FAMILIES[name]
            entries.append((f"{ci}:{name}", fam, fam.make_grid(overrides)))
        pending = validator.dispatch_many(entries, X_tr, y_tr, base_w,
                                          n_classes, dev)
        results: List[ValidationResult] = []
        family_wall: Dict[str, float] = {}
        for key, _fam, _grid in entries:
            results.append(validator.collect(pending[key]))
            batch = pending[key].batch
            family_wall[batch.family] = batch.seconds

        sign = 1.0 if validator.larger_is_better else -1.0
        best = max(results, key=lambda r: sign * r.best_metric)
        fam = MODEL_FAMILIES[best.family]

        # refit the winner on the full training split
        t0 = time.perf_counter()
        Xt, yt, wt = OpValidator._device_data(X_tr, y_tr, base_w, dev)
        hyper = {k: torch.tensor(v, dtype=torch.float32, device=dev)
                 for k, v in best.best_hyper.items()}
        with torch.inference_mode():
            params = fam.fit_kernel(Xt, yt, wt, hyper, n_classes)
            # tree params use +inf no-split thresholds
            check_finite(params_to_numpy(params),
                         f"refit {best.family} parameters", allow_inf=True)
            train_eval = _full_metrics(
                problem, fam.predict_kernel(params, Xt, n_classes), yt)
            holdout_eval = {}
            if len(hold_idx):
                Xh = torch.as_tensor(X[hold_idx], device=dev)
                yh = torch.as_tensor(y[hold_idx], device=dev)
                holdout_eval = _full_metrics(
                    problem, fam.predict_kernel(params, Xh, n_classes), yh)
        refit_wall = time.perf_counter() - t0
        # leave inference mode: the fitted tensors serve later calls
        params = {k: v.clone() for k, v in params.items()}

        summary = {
            "problem": problem,
            "validationType": validator.to_json(),
            "splitterSummary": splitter_summary.to_json(),
            "validationResults": [r.to_json() for r in results],
            "bestModel": {"family": best.family, "hyper": best.best_hyper,
                          "validationMetric": {best.metric_name:
                                               best.best_metric}},
            "trainEvaluation": train_eval,
            "holdoutEvaluation": holdout_eval,
            "dataCounts": {"train": int(len(train_idx)),
                           "holdout": int(len(hold_idx))},
            "wallSeconds": {"families": family_wall, "refit": refit_wall},
        }
        return {"family": best.family, "problem": problem,
                "n_classes": n_classes, "model_params": params,
                "summary": summary}

    def _make_model(self, model_args):
        mp = model_args.pop("model_params")
        summary = model_args.pop("summary")
        model = super()._make_model(model_args)
        model.model_params = mp
        model.summary = summary
        return model


# ---------------------------------------------------------------------------
# Factories (reference: BinaryClassificationModelSelector etc.)
# ---------------------------------------------------------------------------

class _SelectorFactory:
    problem = "binary"

    @classmethod
    def with_cross_validation(cls, n_folds: int = 3,
                              metric: Optional[str] = None,
                              candidates: Optional[List] = None,
                              splitter: Optional[Dict[str, Any]] = None,
                              seed: int = RANDOM_SEED, **kw) -> ModelSelector:
        return ModelSelector(
            problem=cls.problem,
            validation={"type": "crossValidation", "folds": n_folds,
                        "metric": metric or _DEFAULT_METRIC[cls.problem]},
            splitter=splitter, candidates=candidates, seed=seed, **kw)

    @classmethod
    def with_train_validation_split(cls, train_ratio: float = 0.75,
                                    metric: Optional[str] = None,
                                    candidates: Optional[List] = None,
                                    splitter: Optional[Dict[str, Any]] = None,
                                    seed: int = RANDOM_SEED,
                                    **kw) -> ModelSelector:
        return ModelSelector(
            problem=cls.problem,
            validation={"type": "trainValidationSplit",
                        "trainRatio": train_ratio,
                        "metric": metric or _DEFAULT_METRIC[cls.problem]},
            splitter=splitter, candidates=candidates, seed=seed, **kw)


class BinaryClassificationModelSelector(_SelectorFactory):
    problem = "binary"


class MultiClassificationModelSelector(_SelectorFactory):
    problem = "multiclass"


class RegressionModelSelector(_SelectorFactory):
    problem = "regression"
