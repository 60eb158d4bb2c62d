"""Model-stage glue and the model-family protocol.

Counterpart of ``transmogrifai_tpu/models/base.py``. Each model family
is a registered singleton (``MODEL_FAMILIES``: name -> family object,
as in the JAX package) exposing torch kernels

    fit_kernel(X, y, w, hyper, n_classes)  -> params (dict of tensors)
    predict_kernel(params, X, n_classes)   -> (n, k) probabilities or
                                              (n, 1) predictions

on tensors that lie on one device. The JAX package vmaps fits over a
(fold x hyper) grid; in the port a family that validates on a grid
writes the grid axis out (``fit_eval_grid``, the tree families).

:class:`PredictionModel` is the fitted model stage of both halves of
the port: the selector's refit (params on the fit device) and the
serving chain a portable artifact builds (params on the scoring
device). :func:`params_from_numpy` / :func:`params_to_numpy` carry
fitted parameters between the JAX package's numpy pytrees and the
port's tensors. A pytree is nested dicts, lists and tuples (the
FT-Transformer's ``layers`` is a list, which JSON and ``params.npz``
carry as a list) with arrays or tensors at its leaves.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..dataset import Dataset
from ..features import types as ft
from ..stages.base import BinaryEstimator, BinaryTransformer

MODEL_FAMILIES: Dict[str, "ModelFamily"] = {}


class ModelFamily:
    """A trainable model family with torch fit/predict kernels."""

    name: str = ""
    problem_types: Tuple[str, ...] = ()  # of {"binary", "multiclass", "regression"}
    #: hyperparameter defaults; grid values must be numeric (stackable)
    default_hyper: Dict[str, float] = {}
    #: default search grid (reference: DefaultSelectorParams)
    default_grid: Dict[str, List[float]] = {}
    #: include in ModelSelector's default candidate list
    in_default_candidates: bool = True
    #: the fit makes every reduction over rows through ``parallel.spmd``
    #: (``row_sum`` / ``gather_rows``), so it may run with its rows
    #: sharded over a data mesh (a 2-D grid x data sweep); a family
    #: that does not is refused there, never fitted on a shard alone
    rows_sharded: bool = False

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.name:
            MODEL_FAMILIES[cls.name] = cls()

    # -- kernels ---------------------------------------------------------
    def fit_kernel(self, X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                   hyper: Dict[str, torch.Tensor], n_classes: int
                   ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def predict_kernel(self, params: Dict[str, torch.Tensor],
                       X: torch.Tensor, n_classes: int) -> torch.Tensor:
        """Return (n, k) class probabilities, or (n, 1) regression preds."""
        raise NotImplementedError

    # -- grid handling ---------------------------------------------------
    def make_grid(self, overrides: Optional[Dict[str, List[float]]] = None
                  ) -> List[Dict[str, float]]:
        grid = dict(self.default_grid)
        if overrides:
            grid.update(overrides)
        if not grid:
            return [dict(self.default_hyper)]
        keys = sorted(grid)
        combos = []
        for vals in itertools.product(*(grid[k] for k in keys)):
            h = dict(self.default_hyper)
            h.update(dict(zip(keys, vals)))
            combos.append(h)
        return combos

    @staticmethod
    def stack_grid(grid: Sequence[Dict[str, float]]) -> Dict[str, np.ndarray]:
        keys = sorted(grid[0])
        return {k: np.asarray([g[k] for g in grid], dtype=np.float32)
                for k in keys}


@dataclass(frozen=True)
class RowPlan:
    """What a minibatch fit knows on the host of its G items' rows (a
    family with ``takes_row_plan``): item j's rows are the first
    ``rows[j]`` of its X, the training rows of validation fold
    ``folds[j]`` (-1: the winner's refit on the whole training split),
    shuffled by a rule of ``seed``; the last ``padded`` items are copies
    of a real one that fill a sweep chunk."""
    seed: int
    folds: Tuple[int, ...]
    rows: Tuple[int, ...]
    padded: int = 0


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` applied to every leaf of a parameter pytree, its dicts,
    lists and tuples rebuilt around the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a parameter pytree, depth first in key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def params_from_numpy(arrays: Dict[str, Any], device) -> Dict[str, Any]:
    """Numpy parameter pytree (as the JAX package fits and exports it)
    -> the same pytree of tensors on ``device``: integer arrays (tree
    ``feat`` indices) become int64, everything else float32. Nested
    dicts and lists carry over as they are: the sparse families'
    ``table`` / ``dense`` / ``bias`` / ``emb``, FTRL's ``{z: {...},
    n: {...}}`` state, the FT-Transformer's ``layers`` list."""
    def leaf(a):
        a = np.array(a)                  # a writable copy
        dt = (torch.int64 if np.issubdtype(a.dtype, np.integer)
              else torch.float32)
        return torch.as_tensor(a, dtype=dt, device=device)

    return tree_map(leaf, arrays)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_numpy`: integer tensors -> int32
    arrays (the JAX package's index dtype), floats -> float32 arrays."""
    def leaf(t):
        a = t.detach().cpu().numpy()
        return a.astype(np.int32 if np.issubdtype(a.dtype, np.integer)
                        else np.float32)

    return tree_map(leaf, params)


def prediction_column(probs: np.ndarray, problem: str) -> np.ndarray:
    """Build the Prediction object column from a prob/pred matrix."""
    n = probs.shape[0]
    out = np.empty(n, dtype=object)
    if problem == "regression":
        for i in range(n):
            out[i] = {"prediction": float(probs[i, 0])}
        return out
    for i in range(n):
        row = probs[i]
        d = {"prediction": float(np.argmax(row))}
        for j, v in enumerate(row):
            d[f"probability_{j}"] = float(v)
            d[f"rawPrediction_{j}"] = float(v)
        out[i] = d
    return out


def params_on(params: Dict[str, Any], device) -> Dict[str, Any]:
    """The parameter pytree with every tensor on ``device``."""
    return tree_map(lambda v: v.to(device) if isinstance(v, torch.Tensor)
                    else v, params)


def _params_device(params: Dict[str, Any]) -> torch.device:
    for v in tree_leaves(params):
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


class PredictionModel(BinaryTransformer):
    """Fitted model stage: (label, features) -> (n, k) probabilities or
    (n, 1) predictions. ``params`` holds ``family``, ``problem`` and
    ``n_classes`` as in the JAX package; ``model_params`` the fitted
    tensors, all on the model's device (where it scores). The fitted
    tensors persist as the JAX package's numpy pytree
    (``extra_state_json``); a loaded model holds them on the CPU until
    :meth:`to` moves them. It default-constructs, as the JAX package's
    does: the family must be known when the model predicts."""
    in_types = (ft.RealNN, ft.OPVector)
    out_type = ft.Prediction
    operation_name = "pred"

    def __init__(self, input_names=None, output_name=None, *,
                 family: str = "", problem: str = "binary",
                 n_classes: int = 2,
                 model_params: Optional[Dict[str, Any]] = None,
                 uid: Optional[str] = None, **kw):
        super().__init__(input_names, output_name, uid=uid, family=family,
                         problem=problem, n_classes=int(n_classes), **kw)
        self.model_params = dict(model_params or {})

    @property
    def family(self) -> ModelFamily:
        family = self.params["family"]
        if family not in MODEL_FAMILIES:
            raise ValueError(
                f"model family {family!r} is not ported (have "
                f"{sorted(MODEL_FAMILIES)})")
        return MODEL_FAMILIES[family]

    @property
    def device(self) -> torch.device:
        return _params_device(self.model_params)

    def to(self, device) -> "PredictionModel":
        self.model_params = params_on(self.model_params,
                                      torch.device(device))
        return self

    # -- persistence (the JAX package's numpy pytree) -------------------
    def extra_state_json(self):
        return {"model_params": params_to_numpy(self.model_params)}

    def load_extra_state(self, d):
        self.model_params = params_from_numpy(d.get("model_params", {}),
                                              "cpu")

    def portable_spec(self):
        fam = self.family
        spec = {"op": "predict", "family": fam.name,
                "nClasses": int(self.params["n_classes"]),
                "arrays": {"params": params_to_numpy(self.model_params)}}
        if hasattr(fam, "n_heads"):          # FT-Transformer forward shape
            spec["nHeads"] = int(fam.n_heads)
        return spec

    def make_device_fn(self) -> Callable:
        params = self.model_params
        fam = self.family
        n_classes = self.params["n_classes"]

        def fn(label, X):  # label (response) unused at transform time
            return fam.predict_kernel(params, X.to(torch.float32), n_classes)

        return fn

    def predict_probs(self, X: np.ndarray) -> np.ndarray:
        """(n, d) host features -> (n, k) host probabilities, scored on
        the model's device."""
        Xt = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        with torch.inference_mode():
            return self.make_device_fn()(None, Xt).cpu().numpy()

    def _transform_columns(self, ds: Dataset):
        X = ds.column(self.input_names[1]).astype(np.float32)
        probs = self.predict_probs(X)
        return (prediction_column(probs, self.params["problem"]),
                ft.Prediction, None)

    def transform_value(self, label, vec: ft.OPVector):
        X = np.asarray([vec.value], dtype=np.float32)
        col = prediction_column(self.predict_probs(X),
                                self.params["problem"])
        return ft.Prediction(col[0])


class ModelStage(BinaryEstimator):
    """Base estimator for a single model family fit with fixed hypers,
    on ``device`` (None: CUDA, raising without it)."""
    in_types = (ft.RealNN, ft.OPVector)
    out_type = ft.Prediction
    operation_name = "pred"
    model_cls = PredictionModel
    family_name: str = ""
    problem: str = "binary"

    def __init__(self, uid=None, device=None, **hyper):
        fam = MODEL_FAMILIES[self.family_name]
        h = dict(fam.default_hyper)
        h.update(hyper)
        super().__init__(uid=uid, **h)
        self.device = device

    def hyper_values(self) -> Dict[str, float]:
        fam = MODEL_FAMILIES[self.family_name]
        return {k: float(self.params.get(k, v))
                for k, v in fam.default_hyper.items()}

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        label_name, vec_name = self.input_names
        dev = resolve_device(self.device)
        X = torch.as_tensor(ds.column(vec_name).astype(np.float32),
                            device=dev)
        y_np = ds.column(label_name).astype(np.float32)
        n_classes = int(y_np.max()) + 1 if self.problem != "regression" else 1
        if self.problem == "binary":
            n_classes = 2
        y = torch.as_tensor(y_np, device=dev)
        w = torch.ones_like(y)
        fam = MODEL_FAMILIES[self.family_name]
        hyper = {k: torch.tensor(v, dtype=torch.float32, device=dev)
                 for k, v in self.hyper_values().items()}
        params = fam.fit_kernel(X, y, w, hyper, n_classes)
        return {"family": self.family_name, "problem": self.problem,
                "n_classes": n_classes, "model_params": params}

    def _make_model(self, model_args):
        mp = model_args.pop("model_params")
        model = super()._make_model(model_args)
        model.model_params = mp
        return model
