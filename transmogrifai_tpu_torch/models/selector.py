"""ModelSelector: the AutoML heart.

Counterpart of ``transmogrifai_tpu/models/selector.py`` (reference:
selector/ — ModelSelector, SelectedModel, the three factories). Flow:
the splitter prepares data (balance/cut) and reserves a holdout; the
validator cross-validates every candidate (family x hyper grid); the
best (family, hyper) refits on the full training split; train and
holdout metrics and the whole validation grid go into the summary
carried by the fitted SelectedModel.

The fit runs on ``device``, resolved by ``_device.resolve_device`` at
fit time (CUDA unless the caller asks for the CPU); its validation
batches shard over a grid mesh as in the JAX package (``set_mesh``, else
``parallel.default_mesh()`` on CUDA: every configured card). Every candidate family validates: the tree families on the
folded path, the others through the sweep (``tuning``), fused per
family by default or one candidate at a time under
``TM_SWEEP_FUSION=0``. With ``fit_checkpoint_dir`` set, each validated
candidate's result is written as it is collected, and a fit that
stopped resumes after the last one (a drifted configuration or data
raises). The winner's refit passes its value-branching hypers as Python
floats in fused mode (nothing is traced: the float picks the branch).
The fitted model carries ``wall_seconds`` beside its summary: each
family batch's wall and the refit's, host clock, each ending in a copy
to the host. It is transient (neither persisted nor in the summary), so
two identical trains, or a resumed train and its uninterrupted twin,
give equal summaries and bytes.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..dataset import Dataset
from ..evaluators import functional as F
from ..features import types as ft
from ..profiling import check_finite
from ..resilience.atomic import atomic_write_json
from ..resilience.faults import fault_point
from ..stages.base import BinaryEstimator
from ..telemetry.spans import TRACER
from .base import (MODEL_FAMILIES, PredictionModel, RowPlan,
                   params_to_numpy, tree_map)
from .tuning import (OpCrossValidation, OpTrainValidationSplit, OpValidator,
                     RANDOM_SEED, ValidationResult, make_splitter,
                     resolve_sweep_mode, sweep_exact)

_DEFAULT_METRIC = {"binary": "auroc", "multiclass": "error",
                   "regression": "rmse"}


class SelectedModel(PredictionModel):
    """Fitted best model + ModelSelectorSummary."""
    operation_name = "modelSelected"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.summary: Dict[str, Any] = {}
        #: host-clock walls of the fit that made this model (transient:
        #: a loaded model has none)
        self.wall_seconds: Dict[str, Any] = {}

    def extra_state_json(self):
        d = super().extra_state_json()
        d["summary"] = self.summary
        return d

    def load_extra_state(self, d):
        super().load_extra_state(d)
        self.summary = d.get("summary", {})


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

    #: transient fit checkpoint dir (never persisted with the stage):
    #: when set, fit_fn writes each candidate's ValidationResult as it
    #: is collected, and a fit that stopped mid-sweep resumes after the
    #: last one. Guarded by a token over the selector configuration and
    #: the training arrays; a mismatched progress file raises.
    fit_checkpoint_dir = None

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
        super().__init__(uid=uid, problem=problem, validation=validation,
                         splitter=splitter or {}, candidates=candidates,
                         seed=seed, **kw)
        #: where the fit runs (transient, not persisted): None resolves
        #: to CUDA at fit time, raising without a card
        self.device = device
        #: the grid mesh the validation sweep shards over (transient,
        #: not persisted: a fitted model carries results, never the mesh
        #: it was fit on, so a resume may land on another mesh)
        self.mesh = None

    def set_mesh(self, mesh) -> "ModelSelector":
        self.mesh = mesh
        return self

    def _effective_mesh(self, dev: torch.device):
        """The mesh this fit's sweep dispatches on: an explicit set_mesh
        wins; on CUDA the TM_MESH_* default (``parallel.default_mesh``),
        resolved once per fit, so a typo'd knob fails the train before
        any dispatch; on the CPU none (the one device)."""
        if self.mesh is not None:
            return self.mesh
        if dev.type != "cuda":
            return None
        from ..parallel.mesh import default_mesh
        return default_mesh()

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

    # -- fit checkpoint (candidate-level resume) ---------------------------
    def _fit_token(self, X_tr: np.ndarray, y_tr: np.ndarray) -> str:
        """Drift-rejection token for the progress file: the selector's
        configuration and the exact training split."""
        h = hashlib.sha256()
        h.update(json.dumps({"uid": self.uid, "params": self.params},
                            sort_keys=True, default=str).encode())
        h.update(np.ascontiguousarray(X_tr).tobytes())
        h.update(np.ascontiguousarray(y_tr).tobytes())
        return h.hexdigest()

    def _load_fit_progress(self, X_tr: np.ndarray, y_tr: np.ndarray):
        """-> (candidate key -> ValidationResult JSON, progress path,
        token); empty when no fit_checkpoint_dir is set."""
        ckpt_dir = getattr(self, "fit_checkpoint_dir", None)
        if not ckpt_dir:
            return {}, None, None
        token = self._fit_token(X_tr, y_tr)
        path = os.path.join(ckpt_dir, "selector_progress.json")
        if not os.path.exists(path):
            return {}, path, token
        try:
            with open(path) as f:
                doc = json.load(f)
        except ValueError as e:
            raise ValueError(
                f"selector fit checkpoint {path} is unreadable ({e}) — "
                f"delete it to revalidate every family") from e
        if doc.get("format") != 1 or doc.get("token") != token:
            raise ValueError(
                f"selector fit checkpoint {path} was written under a "
                f"different selector configuration or data — delete it "
                f"(or the train checkpoint dir) to start over")
        return dict(doc.get("families") or {}), path, token

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        with TRACER.region("selector.fit", root="fit"):
            return self._fit(ds)

    def _fit(self, ds: Dataset) -> Dict[str, Any]:
        label_name, vec_name = self.input_names
        problem = self.params["problem"]
        dev = resolve_device(self.device)
        mesh = self._effective_mesh(dev)
        with TRACER.region("selector.split"):
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
            progress, prog_path, prog_token = self._load_fit_progress(X_tr,
                                                                      y_tr)
        sweep_mode = resolve_sweep_mode()
        # every live candidate is dispatched before any is collected; a
        # candidate a checkpointed earlier attempt validated loads its
        # recorded result instead (its progress key carries its index,
        # so two candidates of one family never share a result), and
        # the rest re-dispatch as a smaller batch whose items reproduce
        # the uninterrupted fit's (tuning's per-item independence)
        live, order = [], []
        for ci, (name, overrides) in enumerate(self.params["candidates"]):
            key = f"{ci}:{name}"
            fam = MODEL_FAMILIES[name]
            if key in progress:
                order.append((name, key, False))
                continue
            live.append((key, fam, fam.make_grid(overrides)))
            order.append((name, key, True))
        if sweep_mode == "fused":
            pending = (validator.dispatch_many(live, X_tr, y_tr, base_w,
                                               n_classes, mesh, device=dev)
                       if live else {})
        else:
            pending = {key: validator.dispatch(fam, grid, X_tr, y_tr, base_w,
                                               n_classes, mesh, device=dev)
                       for key, fam, grid in live}
        results: List[ValidationResult] = []
        family_wall: Dict[str, float] = {}
        walled = set()
        for name, key, is_live in order:
            if not is_live:
                results.append(ValidationResult.from_json(
                    progress[key], validator.larger_is_better))
                continue
            r = validator.collect(pending[key])
            batch = pending[key].batch
            if id(batch) not in walled:          # a batch once per family
                walled.add(id(batch))
                family_wall[batch.family] = (family_wall.get(batch.family,
                                                             0.0)
                                             + batch.seconds)
            if prog_path is not None:
                progress[key] = r.to_json()
                atomic_write_json(prog_path, {"format": 1,
                                              "token": prog_token,
                                              "families": progress})
            # live validations only, so a resume drill can count which
            # candidates re-ran
            fault_point("models.selector.validate", family=name,
                        stage=self.uid)
            results.append(r)

        sign = 1.0 if validator.larger_is_better else -1.0
        best = max(results, key=lambda r: sign * r.best_metric)
        fam = MODEL_FAMILIES[best.family]

        # refit the winner on the full training split. Fused mode passes
        # the winner's value-branching hypers as Python floats, so the
        # fit runs only the branch they pick (a float-level deviation
        # from the always-traced serial refit, off under
        # TM_SWEEP_FUSION=0 / TM_SWEEP_EXACT=1); the refit depends on no
        # batch, so a resumed fit refits identically
        static: Tuple = ()
        if sweep_mode == "fused" and not sweep_exact():
            keys = getattr(fam, "static_hyper_keys", ())
            static = tuple(sorted((k, float(v))
                                  for k, v in best.best_hyper.items()
                                  if k in keys))
        t0 = time.perf_counter()
        with TRACER.region("selector.refit", family=best.family):
            Xt, yt, wt = OpValidator._device_data(X_tr, y_tr, base_w, dev)
            hyper: Dict[str, Any] = {
                k: torch.tensor(v, dtype=torch.float32, device=dev)
                for k, v in best.best_hyper.items() if k not in dict(static)}
            hyper.update(static)
            # a minibatch family steps through the whole split by its
            # rule of the selector's seed, as the refit (fold -1)
            kw = ({"plan": RowPlan(self.params["seed"], (-1,),
                                   (len(y_tr),))}
                  if getattr(fam, "takes_row_plan", False) else {})
            with torch.inference_mode():
                params = fam.fit_kernel(Xt, yt, wt, hyper, n_classes, **kw)
                # tree params use +inf no-split thresholds
                check_finite(params_to_numpy(params),
                             f"refit {best.family} parameters",
                             allow_inf=True)
                train_eval = _full_metrics(
                    problem, fam.predict_kernel(params, Xt, n_classes), yt)
                holdout_eval = {}
                if len(hold_idx):
                    Xh = torch.as_tensor(X[hold_idx], device=dev)
                    yh = torch.as_tensor(y[hold_idx], device=dev)
                    holdout_eval = _full_metrics(
                        problem, fam.predict_kernel(params, Xh, n_classes),
                        yh)
        refit_wall = time.perf_counter() - t0
        # leave inference mode: the fitted tensors serve later calls
        params = tree_map(torch.Tensor.clone, params)

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
        }
        return {"family": best.family, "problem": problem,
                "n_classes": n_classes, "model_params": params,
                "summary": summary,
                "wall_seconds": {"families": family_wall,
                                 "refit": refit_wall}}

    def _make_model(self, model_args):
        mp = model_args.pop("model_params")
        summary = model_args.pop("summary")
        walls = model_args.pop("wall_seconds")
        model = super()._make_model(model_args)
        model.model_params = mp
        model.summary = summary
        model.wall_seconds = walls
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
