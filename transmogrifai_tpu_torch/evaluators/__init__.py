"""Typed evaluators over Prediction columns.

Counterpart of ``transmogrifai_tpu/evaluators/__init__.py`` (reference:
Evaluators, OpBinaryClassificationEvaluator,
OpMultiClassificationEvaluator, OpRegressionEvaluator,
OpBinScoreEvaluator). Host code: the label and Prediction columns come
out of the Dataset as numpy arrays, the metric kernels of
:mod:`functional` run on the evaluator's ``device`` (None: CUDA, raising
without a card; ``device="cpu"`` on the host), and the metrics come back
as floats and lists.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .._device import resolve_device
from ..dataset import Dataset
from . import functional as F


def _to_np_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in metrics.items():
        arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        out[k] = arr.tolist() if arr.ndim else float(arr)
    return out


def extract_prediction_arrays(ds: Dataset, pred_name: str):
    """Pull (prediction, prob_matrix|None) from a Prediction column."""
    col = ds.column(pred_name)
    preds = np.zeros(len(col), dtype=np.float64)
    # lock prob keys from the first non-empty row (row 0 may be None/{})
    prob_keys = []
    for m in col:
        if m:
            prob_keys = sorted((k for k in m if k.startswith("probability_")),
                               key=lambda k: int(k.split("_")[-1]))
            break
    probs = (np.zeros((len(col), len(prob_keys)), dtype=np.float64)
             if prob_keys else None)
    for i, m in enumerate(col):
        m = m or {}
        preds[i] = float(m.get("prediction", 0.0))
        for j, k in enumerate(prob_keys):
            probs[i, j] = float(m.get(k, 0.0))
    return preds, probs


class Evaluator:
    """Base: evaluate(ds, label, prediction) -> {metric: value}."""
    default_metric: str = ""
    larger_is_better: bool = True
    device = None

    def evaluate(self, ds: Dataset, label: str, prediction: str
                 ) -> Dict[str, Any]:
        raise NotImplementedError

    def default_metric_value(self, metrics: Dict[str, Any]) -> float:
        return float(metrics[self.default_metric])

    def _t(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=resolve_device(self.device))


class BinaryClassificationEvaluator(Evaluator):
    default_metric = "AuROC"
    larger_is_better = True

    def __init__(self, num_thresholds: int = 100,
                 include_curves: bool = False, device=None):
        self.num_thresholds = num_thresholds
        self.include_curves = include_curves
        self.device = device

    def evaluate(self, ds: Dataset, label: str, prediction: str
                 ) -> Dict[str, Any]:
        y = ds.column(label).astype(np.float64)
        preds, probs = extract_prediction_arrays(ds, prediction)
        scores = probs[:, 1] if probs is not None and probs.shape[1] >= 2 \
            else preds
        s, yt = self._t(scores), self._t(y)
        m = F.binary_metrics(s, yt)
        if self.include_curves:
            m.update(F.threshold_curves(s, yt,
                                        num_thresholds=self.num_thresholds))
        return _to_np_metrics(m)


class MultiClassificationEvaluator(Evaluator):
    default_metric = "F1"
    larger_is_better = True

    def __init__(self, topns=(1, 3), num_thresholds: int = 20, device=None):
        self.topns = tuple(int(n) for n in topns)
        self.num_thresholds = int(num_thresholds)
        self.device = device

    def evaluate(self, ds: Dataset, label: str, prediction: str
                 ) -> Dict[str, Any]:
        y = ds.column(label).astype(np.int64)
        preds, probs = extract_prediction_arrays(ds, prediction)
        if probs is None:
            k = int(max(y.max(), preds.max())) + 1
            probs = np.eye(k)[preds.astype(np.int64)]
        p, yt = self._t(probs), self._t(y, torch.int64)
        out = _to_np_metrics(F.multiclass_metrics(p, yt))
        out["ThresholdMetrics"] = _to_np_metrics(
            F.multiclass_topk_threshold_metrics(
                p, yt, topns=self.topns, num_thresholds=self.num_thresholds))
        return out


class RegressionEvaluator(Evaluator):
    default_metric = "RootMeanSquaredError"
    larger_is_better = False

    def __init__(self, device=None):
        self.device = device

    def evaluate(self, ds: Dataset, label: str, prediction: str
                 ) -> Dict[str, Any]:
        y = ds.column(label).astype(np.float64)
        preds, _ = extract_prediction_arrays(ds, prediction)
        return _to_np_metrics(F.regression_metrics(self._t(preds),
                                                   self._t(y)))


class BinScoreEvaluator(Evaluator):
    """Calibration bins + Brier (reference: OpBinScoreEvaluator.scala);
    numpy on the host, as in the JAX package."""
    default_metric = "BrierScore"
    larger_is_better = False

    def __init__(self, num_bins: int = 10):
        self.num_bins = num_bins

    def evaluate(self, ds: Dataset, label: str, prediction: str
                 ) -> Dict[str, Any]:
        y = ds.column(label).astype(np.float64)
        preds, probs = extract_prediction_arrays(ds, prediction)
        scores = probs[:, 1] if probs is not None and probs.shape[1] >= 2 \
            else preds
        bins = np.clip((scores * self.num_bins).astype(int), 0,
                       self.num_bins - 1)
        counts = np.bincount(bins, minlength=self.num_bins).astype(float)
        avg_score = np.bincount(bins, weights=scores,
                                minlength=self.num_bins)
        avg_label = np.bincount(bins, weights=y, minlength=self.num_bins)
        safe = np.maximum(counts, 1.0)
        return {
            "BinCenters": ((np.arange(self.num_bins) + 0.5)
                           / self.num_bins).tolist(),
            "NumberOfDataPoints": counts.tolist(),
            "AverageScore": (avg_score / safe).tolist(),
            "AverageConversionRate": (avg_label / safe).tolist(),
            "BrierScore": float(np.mean((scores - y) ** 2)),
        }


class CustomEvaluator(Evaluator):
    """User-supplied metric (reference: Evaluators.*.custom(metricName,
    isLargerBetter, evaluateFn)). ``evaluate_fn(y, preds, probs)`` gets
    the label array, the predicted-class vector and the per-class
    probability matrix (None when the column has no probabilities) and
    returns a float, or a dict of floats holding ``metric_name``."""

    def __init__(self, metric_name: str, evaluate_fn,
                 larger_is_better: bool = True):
        self.default_metric = metric_name
        self.larger_is_better = bool(larger_is_better)
        self.evaluate_fn = evaluate_fn

    def evaluate(self, ds: Dataset, label: str, prediction: str
                 ) -> Dict[str, Any]:
        preds, probs = extract_prediction_arrays(ds, prediction)
        y = ds.column(label).astype(float)
        out = self.evaluate_fn(y, preds, probs)
        if not isinstance(out, dict):
            out = {self.default_metric: float(out)}
        elif self.default_metric not in out:
            raise ValueError(
                f"custom evaluate_fn returned a dict without the declared "
                f"metric {self.default_metric!r}: {sorted(out)}")
        return _to_np_metrics(out)


class Evaluators:
    """Factory namespace (reference: Evaluators object)."""
    @staticmethod
    def binary_classification(**kw) -> BinaryClassificationEvaluator:
        return BinaryClassificationEvaluator(**kw)

    @staticmethod
    def multi_classification(**kw) -> MultiClassificationEvaluator:
        return MultiClassificationEvaluator(**kw)

    @staticmethod
    def regression(**kw) -> RegressionEvaluator:
        return RegressionEvaluator(**kw)

    @staticmethod
    def bin_score(**kw) -> BinScoreEvaluator:
        return BinScoreEvaluator(**kw)

    @staticmethod
    def custom(metric_name: str, evaluate_fn,
               larger_is_better: bool = True) -> CustomEvaluator:
        return CustomEvaluator(metric_name, evaluate_fn, larger_is_better)


__all__ = ["Evaluator", "BinaryClassificationEvaluator",
           "MultiClassificationEvaluator", "RegressionEvaluator",
           "BinScoreEvaluator", "CustomEvaluator", "Evaluators",
           "functional", "extract_prediction_arrays"]
