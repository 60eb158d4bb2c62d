"""Numeric feature ops: bucketizers, scaler, calibrators.

Reference: core/.../stages/impl/feature/{NumericBucketizer.scala,
DecisionTreeNumericBucketizer.scala, OpQuantileDiscretizer.scala,
OpScalarStandardScaler.scala, PercentileCalibrator.scala,
IsotonicRegressionCalibrator.scala}.

Host-side fitting (one pass over a column), device-friendly outputs:
bucketizers emit one-hot OPVector blocks with manifests; the scaler and
calibrators emit Real columns.

The port's copy of ``transmogrifai_tpu/ops/numeric.py`` (host code; its imports
are relative, so it is the JAX package's text).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..dataset import Dataset
from ..features import types as ft
from ..features.manifest import NULL_INDICATOR, ColumnManifest, ColumnMeta
from ..stages.base import (BinaryEstimator, BinaryTransformer,
                           UnaryEstimator, UnaryTransformer)
from .vectorizers import VectorizerModel


def _bucket_labels(splits: Sequence[float]) -> List[str]:
    return [f"[{splits[i]:g}-{splits[i + 1]:g})"
            for i in range(len(splits) - 1)]


class BucketizerModel(VectorizerModel):
    """Fitted bucketizer: one-hot bucket tracks (+ null track)."""
    in_type = ft.OPNumeric
    operation_name = "bucketize"

    def __init__(self, splits: Sequence[float] = (), track_nulls=True,
                 track_invalid=False, uid=None, **kw):
        super().__init__(uid=uid, splits=[float(s) for s in splits],
                         track_nulls=track_nulls,
                         track_invalid=track_invalid, **kw)

    def manifest(self) -> ColumnManifest:
        splits = self.params["splits"]
        cols = [ColumnMeta(self.parent_name, self.parent_type,
                           indicator_value=lab)
                for lab in _bucket_labels(splits)]
        if self.params["track_invalid"]:
            cols.append(ColumnMeta(self.parent_name, self.parent_type,
                                   indicator_value="OutOfBounds"))
        if self.params["track_nulls"]:
            cols.append(ColumnMeta(self.parent_name, self.parent_type,
                                   indicator_value=NULL_INDICATOR))
        return ColumnManifest(cols)

    def _vectorize(self, col: np.ndarray) -> np.ndarray:
        splits = np.asarray(self.params["splits"], dtype=np.float64)
        col = col.astype(np.float64)
        isnull = np.isnan(col)
        nb = len(splits) - 1
        # right-exclusive buckets; the last bucket includes its upper edge
        idx = np.clip(np.searchsorted(splits, np.nan_to_num(col),
                                      side="right") - 1, -1, nb)
        idx = np.where((np.nan_to_num(col) == splits[-1]), nb - 1, idx)
        in_bounds = (idx >= 0) & (idx < nb) & ~isnull
        width = nb + int(self.params["track_invalid"]) + int(
            self.params["track_nulls"])
        out = np.zeros((len(col), width), dtype=np.float64)
        rows = np.nonzero(in_bounds)[0]
        out[rows, idx[rows].astype(int)] = 1.0
        pos = nb
        if self.params["track_invalid"]:
            out[~in_bounds & ~isnull, pos] = 1.0
            pos += 1
        if self.params["track_nulls"]:
            out[isnull, pos] = 1.0
        return out


class NumericBucketizer(BucketizerModel):
    """Fixed user-provided splits (NumericBucketizer.scala) — stateless."""

    def __init__(self, splits: Sequence[float], track_nulls=True,
                 track_invalid=False, uid=None, **kw):
        splits = [float(s) for s in splits]
        if len(splits) < 2 or any(a >= b for a, b in zip(splits, splits[1:])):
            raise ValueError(f"splits must be strictly increasing, "
                             f"length >= 2: {splits}")
        super().__init__(splits=splits, track_nulls=track_nulls,
                         track_invalid=track_invalid, uid=uid, **kw)


class QuantileDiscretizer(UnaryEstimator):
    """Learn `num_buckets` quantile splits (OpQuantileDiscretizer)."""
    in_type = ft.OPNumeric
    out_type = ft.OPVector
    operation_name = "bucketize"
    model_cls = BucketizerModel

    def __init__(self, num_buckets: int = 2, track_nulls=True, uid=None, **kw):
        super().__init__(uid=uid, num_buckets=num_buckets,
                         track_nulls=track_nulls, **kw)

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        col = ds.column(self.input_names[0]).astype(np.float64)
        vals = col[~np.isnan(col)]
        k = int(self.params["num_buckets"])
        if len(vals) == 0:
            inner = []
        else:
            qs = np.quantile(vals, np.linspace(0, 1, k + 1)[1:-1])
            inner = sorted(set(float(q) for q in qs))
        # +/-inf outer edges: out-of-range inference values land in the
        # first/last bucket (Spark QuantileDiscretizer semantics), never
        # in an OutOfBounds track
        splits = [float("-inf")] + inner + [float("inf")]
        return {"splits": splits, "track_nulls": self.params["track_nulls"],
                "track_invalid": False}


def _best_split(vals: np.ndarray, y: np.ndarray, candidates: np.ndarray,
                is_classification: bool) -> Tuple[Optional[float], float]:
    """Best single split by impurity decrease (gini / variance)."""

    def impurity(yy: np.ndarray) -> float:
        if len(yy) == 0:
            return 0.0
        if is_classification:
            _, counts = np.unique(yy, return_counts=True)
            p = counts / counts.sum()
            return float(1.0 - np.sum(p * p))
        return float(np.var(yy))

    base = impurity(y) * len(y)
    best_gain, best_split_v = 0.0, None
    for c in candidates:
        left = y[vals < c]
        right = y[vals >= c]
        if len(left) == 0 or len(right) == 0:
            continue
        gain = base - impurity(left) * len(left) - impurity(right) * len(right)
        if gain > best_gain:
            best_gain, best_split_v = gain, float(c)
    return best_split_v, best_gain


def _fit_tree_splits(vals: np.ndarray, y: np.ndarray, max_depth: int,
                     min_samples: int, min_gain: float,
                     is_cls: bool) -> List[float]:
    """Recursive impurity-gain split search shared by the unary and map
    supervised bucketizers (ONE implementation so they can never learn
    different buckets for identical data). Inputs must already be
    NaN-free. Returns the full split list with +/-inf outer edges."""
    splits: List[float] = []

    def recurse(v: np.ndarray, yy: np.ndarray, depth: int):
        if depth >= max_depth or len(v) < min_samples:
            return
        cands = np.unique(np.quantile(v, np.linspace(0.05, 0.95, 19)))
        s, gain = _best_split(v, yy, cands, is_cls)
        if s is None or gain / max(len(yy), 1) < min_gain:
            return
        splits.append(s)
        recurse(v[v < s], yy[v < s], depth + 1)
        recurse(v[v >= s], yy[v >= s], depth + 1)

    if len(vals):
        recurse(vals, y, 0)
    return [float("-inf")] + sorted(set(splits)) + [float("inf")]


class DecisionTreeNumericBucketizer(BinaryEstimator):
    """Supervised buckets: recursive impurity-gain splits of one numeric
    feature against the label (DecisionTreeNumericBucketizer.scala).
    Inputs (label, numeric); output one-hot bucket OPVector."""
    in_types = (ft.RealNN, ft.OPNumeric)
    out_type = ft.OPVector
    operation_name = "dtBucketize"
    model_cls = BucketizerModel

    def __init__(self, max_depth: int = 2, min_gain: float = 1e-4,
                 min_samples: int = 10, track_nulls=True, uid=None, **kw):
        super().__init__(uid=uid, max_depth=max_depth, min_gain=min_gain,
                         min_samples=min_samples, track_nulls=track_nulls,
                         **kw)

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        y_all = ds.column(self.input_names[0]).astype(np.float64)
        col = ds.column(self.input_names[1]).astype(np.float64)
        mask = ~np.isnan(col) & ~np.isnan(y_all)
        vals, y = col[mask], y_all[mask]
        uniq = np.unique(y)
        is_cls = len(uniq) <= 20 and np.allclose(uniq, np.round(uniq))
        full = _fit_tree_splits(vals, y, int(self.params["max_depth"]),
                                int(self.params["min_samples"]),
                                self.params["min_gain"], is_cls)
        return {"splits": full, "track_nulls": self.params["track_nulls"],
                "track_invalid": False}

    def _make_model(self, model_args):
        model = super()._make_model(model_args)
        # bucketizer vectorizes only the numeric input (second slot)
        model.inputs = (self.inputs[1],)
        model.in_types = (ft.OPNumeric,)
        return model


class ScalarStandardScaler(UnaryEstimator):
    """(x - mean) / std -> Real (OpScalarStandardScaler)."""
    in_type = ft.OPNumeric
    out_type = ft.Real
    operation_name = "stdScaled"

    class Model(UnaryTransformer):
        in_type = ft.OPNumeric
        out_type = ft.Real
        operation_name = "stdScaled"

        def __init__(self, mean=0.0, std=1.0, uid=None, **kw):
            super().__init__(uid=uid, mean=mean, std=std, **kw)

        def _transform_columns(self, ds: Dataset):
            col = ds.column(self.input_names[0]).astype(np.float64)
            std = self.params["std"] or 1.0
            return (col - self.params["mean"]) / std, ft.Real, None

        def transform_value(self, v: ft.OPNumeric):
            if v.value is None:
                return ft.Real(None)
            std = self.params["std"] or 1.0
            return ft.Real((float(v.value) - self.params["mean"]) / std)

    model_cls = Model

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        col = ds.column(self.input_names[0]).astype(np.float64)
        vals = col[~np.isnan(col)]
        mean = float(vals.mean()) if len(vals) else 0.0
        std = float(vals.std()) if len(vals) else 1.0
        return {"mean": mean, "std": std if std > 0 else 1.0}


class FillMissingWithMean(UnaryEstimator):
    """Impute nulls with the train-time mean, yielding non-nullable
    RealNN (RichNumericFeature.fillMissingWithMean; `default` fills
    when the train column is entirely null)."""
    in_type = ft.OPNumeric
    out_type = ft.RealNN
    operation_name = "fillMissingWithMean"

    class Model(UnaryTransformer):
        in_type = ft.OPNumeric
        out_type = ft.RealNN
        operation_name = "fillMissingWithMean"

        def __init__(self, mean: float = 0.0, uid=None, **kw):
            super().__init__(uid=uid, mean=float(mean), **kw)

        def _transform_columns(self, ds: Dataset):
            col = ds.column(self.input_names[0]).astype(np.float64)
            return np.where(np.isnan(col), self.params["mean"], col), \
                ft.RealNN, None

        def transform_value(self, v: ft.OPNumeric):
            x = v.value
            if x is None or (isinstance(x, float) and np.isnan(x)):
                return ft.RealNN(self.params["mean"])
            return ft.RealNN(float(x))

    model_cls = Model

    def __init__(self, default: float = 0.0, uid=None, **kw):
        super().__init__(uid=uid, default=float(default), **kw)

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        col = ds.column(self.input_names[0]).astype(np.float64)
        vals = col[~np.isnan(col)]
        mean = float(vals.mean()) if len(vals) else self.params["default"]
        return {"mean": mean}


class PercentileCalibrator(UnaryEstimator):
    """Map a score into its empirical percentile bucket 0..99
    (PercentileCalibrator.scala)."""
    in_type = ft.OPNumeric
    out_type = ft.RealNN
    operation_name = "percentile"

    class Model(UnaryTransformer):
        in_type = ft.OPNumeric
        out_type = ft.RealNN
        operation_name = "percentile"

        def __init__(self, edges: Sequence[float] = (), buckets: int = 100,
                     uid=None, **kw):
            super().__init__(uid=uid, edges=[float(e) for e in edges],
                             buckets=buckets, **kw)

        def _calibrate(self, col: np.ndarray) -> np.ndarray:
            edges = np.asarray(self.params["edges"], dtype=np.float64)
            col = np.nan_to_num(col.astype(np.float64))
            idx = np.searchsorted(edges, col, side="right")
            return np.clip(idx, 0, self.params["buckets"] - 1).astype(
                np.float64)

        def _transform_columns(self, ds: Dataset):
            col = ds.column(self.input_names[0]).astype(np.float64)
            return self._calibrate(col), ft.RealNN, None

        def transform_value(self, v: ft.OPNumeric):
            x = 0.0 if v.value is None else float(v.value)
            return ft.RealNN(float(self._calibrate(np.array([x]))[0]))

    model_cls = Model

    def __init__(self, buckets: int = 100, uid=None, **kw):
        super().__init__(uid=uid, buckets=buckets, **kw)

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        col = ds.column(self.input_names[0]).astype(np.float64)
        vals = col[~np.isnan(col)]
        b = int(self.params["buckets"])
        if len(vals) == 0:
            return {"edges": [], "buckets": b}
        qs = np.quantile(vals, np.linspace(0, 1, b + 1)[1:-1])
        return {"edges": [float(q) for q in qs], "buckets": b}


def _pava(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Pool-adjacent-violators: weighted isotonic means."""
    means = y.astype(np.float64)
    weights = w.astype(np.float64)
    vals: List[float] = []
    ws: List[float] = []
    idx: List[int] = []
    for i in range(len(y)):
        cur_v, cur_w = means[i], weights[i]
        cur_i = i
        while vals and vals[-1] > cur_v:
            pv, pw = vals.pop(), ws.pop()
            cur_i = idx.pop()
            cur_v = (pv * pw + cur_v * cur_w) / (pw + cur_w)
            cur_w = pw + cur_w
        vals.append(cur_v)
        ws.append(cur_w)
        idx.append(cur_i)
    out = np.empty(len(y), dtype=np.float64)
    bounds = idx + [len(y)]
    for k in range(len(vals)):
        out[bounds[k]:bounds[k + 1]] = vals[k]
    return out


class IsotonicRegressionCalibrator(BinaryEstimator):
    """Monotone score calibration via isotonic regression (PAVA).

    Inputs (label RealNN, score); output calibrated RealNN
    (IsotonicRegressionCalibrator.scala — Spark's IsotonicRegression).
    """
    in_types = (ft.RealNN, ft.OPNumeric)
    out_type = ft.RealNN
    operation_name = "isoCalibrated"

    class Model(UnaryTransformer):
        in_type = ft.OPNumeric
        out_type = ft.RealNN
        operation_name = "isoCalibrated"

        def __init__(self, boundaries: Sequence[float] = (),
                     predictions: Sequence[float] = (), uid=None, **kw):
            super().__init__(uid=uid,
                             boundaries=[float(b) for b in boundaries],
                             predictions=[float(p) for p in predictions],
                             **kw)

        def _calibrate(self, col: np.ndarray) -> np.ndarray:
            xs = np.asarray(self.params["boundaries"], dtype=np.float64)
            ys = np.asarray(self.params["predictions"], dtype=np.float64)
            col = np.nan_to_num(col.astype(np.float64))
            if len(xs) == 0:
                return np.zeros_like(col)
            return np.interp(col, xs, ys)

        def _transform_columns(self, ds: Dataset):
            col = ds.column(self.input_names[0]).astype(np.float64)
            return self._calibrate(col), ft.RealNN, None

        def transform_value(self, v: ft.OPNumeric):
            x = 0.0 if v.value is None else float(v.value)
            return ft.RealNN(float(self._calibrate(np.array([x]))[0]))

    model_cls = Model

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        y = ds.column(self.input_names[0]).astype(np.float64)
        x = ds.column(self.input_names[1]).astype(np.float64)
        mask = ~np.isnan(x) & ~np.isnan(y)
        x, y = x[mask], y[mask]
        if len(x) == 0:
            return {"boundaries": [], "predictions": []}
        order = np.argsort(x, kind="stable")
        xs, ys = x[order], y[order]
        # collapse duplicate x to weighted means (required by isotonic fit)
        ux, inv, counts = np.unique(xs, return_inverse=True,
                                    return_counts=True)
        sums = np.zeros(len(ux))
        np.add.at(sums, inv, ys)
        my = sums / counts
        fitted = _pava(my, counts.astype(np.float64))
        return {"boundaries": [float(v) for v in ux],
                "predictions": [float(v) for v in fitted]}

    def _make_model(self, model_args):
        model = super()._make_model(model_args)
        model.inputs = (self.inputs[1],)  # calibrate the score input only
        return model


# ---------------------------------------------------------------------------
# Scaler / Descaler family
# Reference: core/.../stages/impl/feature/{ScalerTransformer.scala,
# DescalerTransformer.scala, PredictionDescalerTransformer.scala} with
# LinearScaler/LogScaler ScalerMetadata: scale a numeric feature (most
# commonly a regression label) and invert the transform downstream — the
# descalers resolve the forward transform FROM THE SCALED FEATURE'S
# ORIGIN STAGE, exactly like the reference reads ScalerMetadata off the
# input column, so the inverse can never drift from the forward pass.
# ---------------------------------------------------------------------------

_SCALINGS = ("linear", "log")


class ScalerTransformer(UnaryTransformer):
    """Scale a numeric feature: "linear" (slope*x + intercept) or "log"
    (natural log; non-positive inputs -> null/NaN). The fitted params
    ARE the scaler metadata the descalers read.

    Like the reference's generic ScalerTransformer[I, O], the output
    preserves the input's non-null type AND response-ness, so the
    canonical use — scale the label, train the selector on the scaled
    feature, descale predictions — type-checks end to end. (With "log"
    on a RealNN, non-positive inputs become NaN; positive labels are
    the caller's contract, as upstream.)"""
    in_type = ft.OPNumeric
    out_type = ft.Real
    operation_name = "scaled"

    def output_type(self, features):
        # RealNN survives only where non-null is actually guaranteed:
        # linear scaling is total; log keeps RealNN only for the LABEL
        # case (positive labels are the caller's contract, and scoring
        # rows take the response placeholder) — a log-scaled RealNN
        # PREDICTOR honestly becomes nullable Real
        if issubclass(features[0].wtype, ft.RealNN) and (
                self.params["scaling_type"] == "linear"
                or features[0].is_response):
            return ft.RealNN
        return ft.Real

    def output_is_response(self, features):
        return features[0].is_response

    def __init__(self, scaling_type: str = "linear", slope: float = 1.0,
                 intercept: float = 0.0, uid=None, **kw):
        if scaling_type not in _SCALINGS:
            raise ValueError(f"scaling_type must be one of {_SCALINGS}, "
                             f"got {scaling_type!r}")
        if scaling_type == "linear" and float(slope) == 0.0:
            raise ValueError("linear scaling needs slope != 0 "
                             "(a zero slope cannot be descaled)")
        super().__init__(uid=uid, scaling_type=scaling_type,
                         slope=float(slope), intercept=float(intercept),
                         **kw)

    def _apply(self, col: np.ndarray) -> np.ndarray:
        if self.params["scaling_type"] == "linear":
            return col * self.params["slope"] + self.params["intercept"]
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.log(col)
        out[~(col > 0)] = np.nan
        return out

    def _out_type_and_resp(self):
        if self._output is None:
            return ft.Real, False
        return self._output.wtype, self._output.is_response

    def _transform_columns(self, ds: Dataset):
        col = ds.column(self.input_names[0]).astype(np.float64)
        out = self._apply(col.copy())
        out_t, is_resp = self._out_type_and_resp()
        if out_t is ft.RealNN and is_resp:
            # match the row path: undefined scaled-label values take
            # the neutral response placeholder (model stages ignore
            # the label at scoring; training labels are positive by
            # the log contract)
            out = np.where(np.isnan(out), 0.0, out)
        return out, out_t, None

    def transform_value(self, v: ft.OPNumeric):
        out_t, is_resp = self._out_type_and_resp()
        if v.value is not None:
            out = float(self._apply(np.asarray([float(v.value)]))[0])
            if not np.isnan(out):
                return out_t(out)
        if out_t is ft.RealNN and is_resp:
            # label-free scoring rows: same placeholder the row
            # harness substitutes for missing responses
            return out_t(0.0)
        return ft.Real(None)


def _descale(vals: np.ndarray, scaling: Dict[str, Any]) -> np.ndarray:
    if scaling["scaling_type"] == "linear":
        return (vals - scaling["intercept"]) / scaling["slope"]
    return np.exp(vals)


class _DescalerBase(BinaryTransformer):
    """Shared wiring: at set_input time the SECOND feature's origin
    stage must be a ScalerTransformer (the reference's requirement —
    descaling reads ScalerMetadata off the scaled column); its forward
    params are captured into this stage's own params so they persist
    with the stage and serve the batch, row, and loaded paths alike."""

    def __init__(self, scaling: Optional[Dict[str, Any]] = None,
                 uid=None, **kw):
        super().__init__(uid=uid, scaling=dict(scaling or {}), **kw)

    def set_input(self, *features):
        st = getattr(features[1], "origin_stage", None)
        if not isinstance(st, ScalerTransformer):
            raise ValueError(
                f"feature {features[1].name!r} was not produced by a "
                f"ScalerTransformer (origin: {type(st).__name__}); "
                "descalers invert the origin scaler and need one to read")
        self.params["scaling"] = {
            "scaling_type": st.params["scaling_type"],
            "slope": st.params["slope"],
            "intercept": st.params["intercept"]}
        return super().set_input(*features)

    def _scaling(self) -> Dict[str, Any]:
        if not self.params.get("scaling"):
            raise ValueError(f"{type(self).__name__} has no captured "
                             "scaling — set_input was never called")
        return self.params["scaling"]


class DescalerTransformer(_DescalerBase):
    """(value_to_descale, scaled_feature) -> Real with the scaled
    feature's origin transform inverted."""
    in_types = (ft.OPNumeric, ft.OPNumeric)
    out_type = ft.Real
    operation_name = "descaled"

    def _transform_columns(self, ds: Dataset):
        col = ds.column(self.input_names[0]).astype(np.float64)
        return _descale(col, self._scaling()), ft.Real, None

    def transform_value(self, v: ft.OPNumeric, scaled: ft.OPNumeric):
        if v.value is None:
            return ft.Real(None)
        return ft.Real(float(_descale(np.asarray([float(v.value)]),
                                      self._scaling())[0]))


class PredictionDescaler(_DescalerBase):
    """(Prediction, scaled_label_feature) -> Real: the regression
    workflow pattern — train on a log/linear-scaled label, serve
    predictions in the original units."""
    in_types = (ft.Prediction, ft.OPNumeric)
    out_type = ft.Real
    operation_name = "descaledPrediction"

    def _transform_columns(self, ds: Dataset):
        col = ds.column(self.input_names[0])
        vals = np.asarray([float((m or {}).get("prediction", np.nan))
                           for m in col], np.float64)
        return _descale(vals, self._scaling()), ft.Real, None

    def transform_value(self, p: ft.Prediction, scaled: ft.OPNumeric):
        # same tolerance as the batch path: absent prediction -> null
        v = (p.value or {}).get("prediction")
        if v is None:
            return ft.Real(None)
        return ft.Real(float(_descale(np.asarray([float(v)]),
                                      self._scaling())[0]))


class DecisionTreeNumericMapBucketizer(BinaryEstimator):
    """Supervised buckets for EVERY key of a numeric map: the same
    impurity-gain recursion as DecisionTreeNumericBucketizer, fitted
    per key, emitting one-hot bucket tracks (+ null track) per key.
    Reference: DecisionTreeNumericMapBucketizer.scala."""
    in_types = (ft.RealNN, ft.OPMap)
    out_type = ft.OPVector
    operation_name = "dtMapBucketize"

    class Model(VectorizerModel):
        in_type = ft.OPMap
        operation_name = "dtMapBucketize"

        def __init__(self, keys: Sequence[str] = (),
                     splits: Dict[str, List[float]] = None,
                     track_nulls=True, uid=None, **kw):
            super().__init__(uid=uid, keys=list(keys),
                             splits=dict(splits or {}),
                             track_nulls=track_nulls, **kw)

        def _key_width(self, k: str) -> int:
            nb = len(self.params["splits"][k]) - 1
            return nb + (1 if self.params["track_nulls"] else 0)

        def manifest(self) -> ColumnManifest:
            p, t = self.parent_name, self.parent_type
            cols = []
            for k in self.params["keys"]:
                sp = self.params["splits"][k]
                for lab in _bucket_labels(sp):
                    cols.append(ColumnMeta(p, t, grouping=k,
                                           indicator_value=lab))
                if self.params["track_nulls"]:
                    cols.append(ColumnMeta(p, t, grouping=k,
                                           indicator_value=NULL_INDICATOR))
            return ColumnManifest(cols)

        def _vectorize(self, col: np.ndarray) -> np.ndarray:
            keys = self.params["keys"]
            tn = self.params["track_nulls"]
            widths = [self._key_width(k) for k in keys]
            out = np.zeros((len(col), sum(widths)), dtype=np.float64)
            for r, m in enumerate(col):
                m = m or {}
                base = 0
                for k, wd in zip(keys, widths):
                    sp = self.params["splits"][k]
                    v = m.get(k)
                    # NaN values take the null track, matching the
                    # unary BucketizerModel (searchsorted on NaN would
                    # silently land in the top bucket)
                    if v is None or np.isnan(float(v)):
                        if tn:
                            out[r, base + wd - 1] = 1.0
                    else:
                        b = int(np.searchsorted(sp, float(v),
                                                side="right")) - 1
                        b = min(max(b, 0), len(sp) - 2)
                        out[r, base + b] = 1.0
                    base += wd
            return out

    model_cls = Model

    def __init__(self, max_depth: int = 2, min_gain: float = 1e-4,
                 min_samples: int = 10, track_nulls=True, uid=None, **kw):
        super().__init__(uid=uid, max_depth=max_depth, min_gain=min_gain,
                         min_samples=min_samples, track_nulls=track_nulls,
                         **kw)

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        y_all = ds.column(self.input_names[0]).astype(np.float64)
        col = ds.column(self.input_names[1])
        per_key: Dict[str, List[Tuple[float, float]]] = {}
        for m, yy in zip(col, y_all):
            if np.isnan(yy):
                continue
            for k, v in (m or {}).items():
                # NaN map values are nulls, exactly like the unary
                # bucketizer's mask — one NaN must not poison the
                # quantile candidate grid for the whole key
                if v is not None and not np.isnan(float(v)):
                    per_key.setdefault(k, []).append((float(v), yy))
        uniq = np.unique(y_all[~np.isnan(y_all)])
        is_cls = len(uniq) <= 20 and np.allclose(uniq, np.round(uniq))

        splits_by_key: Dict[str, List[float]] = {}
        for k, pairs in sorted(per_key.items()):
            arr = np.asarray(pairs, np.float64)
            splits_by_key[k] = _fit_tree_splits(
                arr[:, 0], arr[:, 1], int(self.params["max_depth"]),
                int(self.params["min_samples"]), self.params["min_gain"],
                is_cls)
        return {"keys": sorted(splits_by_key),
                "splits": splits_by_key,
                "track_nulls": self.params["track_nulls"]}

    def _make_model(self, model_args):
        model = super()._make_model(model_args)
        model.inputs = (self.inputs[1],)   # vectorize the map input only
        return model
