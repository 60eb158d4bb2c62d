"""Wrappers turning arbitrary fit/transform objects into typed stages.

Reference: core/.../stages/sparkwrappers/{generic,specific}/ —
OpEstimatorWrapper / OpTransformerWrapper / OpPredictorWrapper wrap any
Spark ML stage as an OP stage with typed IO and persistence. The TPU
analog wraps any object with the sklearn-style protocol:

- EstimatorWrapper: obj.fit(X, y?) then obj.transform(X) (or predict /
  predict_proba via PredictorWrapper)
- TransformerWrapper: obj.transform(X)

X is the dense feature block of the input OPVector column (or a stacked
(n, k) block of numeric columns). Persistence: wrapped objects serialize
via pickle into the stage JSON (base64) — the wrapper records the class
path so loads fail loudly when the class is missing, mirroring the
reference's requirement that wrapped Spark stages be on the classpath.

SECURITY: unpickling executes arbitrary code, so a saved model containing
wrapped stages must only be loaded if it comes from a trusted source (the
classPath import check guards availability, not safety). Set the env var
TM_DISALLOW_PICKLE=1 (exactly "1") to refuse loading pickled wrapped stages
(e.g. when serving models of unknown provenance); native OP stages are
JSON+numpy and load regardless.

The port's copy of ``transmogrifai_tpu/stages/wrappers.py`` (host code; its imports
are relative, so it is the JAX package's text).
"""
from __future__ import annotations

import base64
import importlib
import os
import pickle
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..dataset import Dataset
from ..features import types as ft
from ..features.manifest import ColumnManifest, ColumnMeta
from .base import BinaryEstimator, Transformer, UnaryEstimator, UnaryTransformer


def _encode_obj(obj: Any) -> Dict[str, str]:
    cls = type(obj)
    return {"pickle": base64.b64encode(pickle.dumps(obj)).decode(),
            "classPath": f"{cls.__module__}.{cls.__qualname__}"}


def _decode_obj(d: Dict[str, str]) -> Any:
    if os.environ.get("TM_DISALLOW_PICKLE", "0") == "1":
        raise RuntimeError(
            "refusing to unpickle wrapped stage "
            f"{d.get('classPath', '<unknown>')}: TM_DISALLOW_PICKLE is set "
            "(unpickling executes arbitrary code; only load saved models "
            "from trusted sources)")
    mod, _, name = d["classPath"].rpartition(".")
    try:  # fail loudly if the wrapped class's module is missing
        importlib.import_module(mod)
    except ImportError as e:
        raise ImportError(
            f"wrapped stage class {d['classPath']} unavailable: {e}") from e
    return pickle.loads(base64.b64decode(d["pickle"]))


def _matrix(ds: Dataset, name: str) -> np.ndarray:
    col = ds.column(name)
    if col.ndim == 2:
        return col.astype(np.float64)
    return col.astype(np.float64)[:, None]


class WrappedModel(UnaryTransformer):
    """Fitted wrapper: applies obj.transform / predict_proba / predict."""
    in_type = ft.OPVector
    out_type = ft.OPVector
    operation_name = "wrapped"

    def __init__(self, wrapped: Any = None, method: str = "transform",
                 uid=None, **kw):
        super().__init__(uid=uid, method=method, **kw)
        self.wrapped = wrapped

    def extra_state_json(self):
        return {"wrapped": _encode_obj(self.wrapped)}

    def load_extra_state(self, d):
        self.wrapped = _decode_obj(d["wrapped"])

    def _apply(self, X: np.ndarray) -> np.ndarray:
        out = np.asarray(getattr(self.wrapped, self.params["method"])(X))
        return out if out.ndim == 2 else out[:, None]

    def _transform_columns(self, ds: Dataset):
        out = self._apply(_matrix(ds, self.input_names[0]))
        manifest = ColumnManifest([
            ColumnMeta(self.inputs[0].name, self.inputs[0].wtype.__name__,
                       descriptor_value=f"wrapped_{i}")
            for i in range(out.shape[1])])
        return out.astype(np.float32), ft.OPVector, manifest

    def transform_value(self, v: ft.OPVector):
        out = self._apply(np.asarray([v.value], dtype=np.float64))
        return ft.OPVector(tuple(float(x) for x in out[0]))


class TransformerWrapper(WrappedModel):
    """Stateless wrapper around an already-fitted/stateless transformer
    (OpTransformerWrapper)."""


class EstimatorWrapper(UnaryEstimator):
    """Wrap an unsupervised estimator: obj.fit(X) -> obj.transform(X)
    (OpEstimatorWrapper)."""
    in_type = ft.OPVector
    out_type = ft.OPVector
    operation_name = "wrapped"
    model_cls = WrappedModel

    def __init__(self, estimator: Any = None, method: str = "transform",
                 uid=None, **kw):
        super().__init__(uid=uid, method=method, **kw)
        self.estimator = estimator

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        import copy
        est = copy.deepcopy(self.estimator)  # keep the template reusable
        est.fit(_matrix(ds, self.input_names[0]))
        return {"wrapped": est, "method": self.params["method"]}


class PredictorWrapper(BinaryEstimator):
    """Wrap a supervised predictor: obj.fit(X, y) then predict_proba /
    predict -> Prediction column (OpPredictorWrapper).

    Inputs (label RealNN, features OPVector); problem inferred from the
    wrapped object's surface (predict_proba => classifier).
    """
    in_types = (ft.RealNN, ft.OPVector)
    out_type = ft.Prediction
    operation_name = "wrappedPred"

    class Model(Transformer):
        in_types = (ft.RealNN, ft.OPVector)
        out_type = ft.Prediction
        operation_name = "wrappedPred"

        def __init__(self, wrapped: Any = None, uid=None, **kw):
            super().__init__(uid=uid, **kw)
            self.wrapped = wrapped

        def extra_state_json(self):
            return {"wrapped": _encode_obj(self.wrapped)}

        def load_extra_state(self, d):
            self.wrapped = _decode_obj(d["wrapped"])

        def _predict(self, X: np.ndarray):
            from ..models.base import prediction_column
            if hasattr(self.wrapped, "predict_proba"):
                probs = np.asarray(self.wrapped.predict_proba(X))
                return prediction_column(probs, "binary"
                                         if probs.shape[1] == 2
                                         else "multiclass")
            preds = np.asarray(self.wrapped.predict(X), dtype=np.float64)
            return prediction_column(preds[:, None], "regression")

        def _transform_columns(self, ds: Dataset):
            X = _matrix(ds, self.input_names[1])
            return self._predict(X), ft.Prediction, None

        def transform_value(self, label, vec: ft.OPVector):
            out = self._predict(np.asarray([vec.value], dtype=np.float64))
            return ft.Prediction(out[0])

    model_cls = Model

    def __init__(self, predictor: Any = None, uid=None, **kw):
        super().__init__(uid=uid, **kw)
        self.predictor = predictor

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        import copy
        est = copy.deepcopy(self.predictor)
        y = ds.column(self.input_names[0]).astype(np.float64)
        X = _matrix(ds, self.input_names[1])
        est.fit(X, y)
        return {"wrapped": est}
