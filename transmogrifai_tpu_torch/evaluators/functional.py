"""Weighted metric kernels on tensors.

Counterpart of ``transmogrifai_tpu/evaluators/functional.py``
(reference: OpBinaryClassificationEvaluator, OpMultiClassification-
Evaluator, OpRegressionEvaluator). Every metric takes an explicit
sample-weight vector, so a CV fold is a 0/1 weight mask and the same
kernel scores plain and per-fold metrics. AUROC uses the searchsorted
mid-rank tie correction (sklearn's value on tied scores).

Sorts are stable (``stable=True``): ``jnp.argsort`` is stable and
``torch.argsort`` is not by default, and tied scores are common with
tree models (every row of a leaf scores alike). Sums run in f32 in
another order than XLA's, so results agree with the JAX package to
float tolerance, not bitwise.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

EPS = 1e-12


def _w(weights: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    return (torch.ones_like(like, dtype=torch.float32) if weights is None
            else weights.to(torch.float32))


def _one_hot(labels: torch.Tensor, k: int) -> torch.Tensor:
    """jax.nn.one_hot semantics: a label outside [0, k) is all zeros."""
    lab = labels.to(torch.int64)
    return (lab[:, None] == torch.arange(k, device=lab.device)
            ).to(torch.float32)


# ---------------------------------------------------------------------------
# Binary classification
# ---------------------------------------------------------------------------

def auroc(scores: torch.Tensor, labels: torch.Tensor,
          weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted area under ROC with mid-rank tie correction."""
    w = _w(weights, scores)
    y = labels.to(torch.float32)
    order = torch.argsort(scores, stable=True)
    s = scores[order].contiguous()
    posw = (w * y)[order]
    negw = (w * (1.0 - y))[order]
    cn = torch.cat([torch.zeros(1, dtype=torch.float32, device=s.device),
                    torch.cumsum(negw, 0)])
    il = torch.searchsorted(s, s, side="left")
    ir = torch.searchsorted(s, s, side="right")
    neg_less = cn[il]
    neg_tied = cn[ir] - cn[il]
    p_tot = torch.sum(posw)
    n_tot = torch.sum(negw)
    num = torch.sum(posw * (neg_less + 0.5 * neg_tied))
    return num / torch.clamp(p_tot * n_tot, min=EPS)


def aupr(scores: torch.Tensor, labels: torch.Tensor,
         weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted average precision (step-wise, descending-score sweep)."""
    w = _w(weights, scores)
    y = labels.to(torch.float32)
    order = torch.argsort(-scores, stable=True)
    posw = (w * y)[order]
    allw = w[order]
    precision = torch.cumsum(posw, 0) / torch.clamp(torch.cumsum(allw, 0),
                                                    min=EPS)
    p_tot = torch.clamp(torch.sum(posw), min=EPS)
    return torch.sum(posw * precision) / p_tot


def binary_confusion(scores: torch.Tensor, labels: torch.Tensor,
                     weights: Optional[torch.Tensor] = None,
                     threshold: float = 0.5) -> Tuple[torch.Tensor, ...]:
    w = _w(weights, scores)
    y = labels.to(torch.float32)
    pred = (scores >= threshold).to(torch.float32)
    tp = torch.sum(w * pred * y)
    fp = torch.sum(w * pred * (1 - y))
    fn = torch.sum(w * (1 - pred) * y)
    tn = torch.sum(w * (1 - pred) * (1 - y))
    return tp, fp, fn, tn


def binary_metrics(scores: torch.Tensor, labels: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    tp, fp, fn, tn = binary_confusion(scores, labels, weights, threshold)
    precision = tp / torch.clamp(tp + fp, min=EPS)
    recall = tp / torch.clamp(tp + fn, min=EPS)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=EPS)
    w = _w(weights, scores)
    y = labels.to(torch.float32)
    tot = torch.clamp(torch.sum(w), min=EPS)
    s = torch.clamp(scores, EPS, 1 - EPS)
    return {
        "AuROC": auroc(scores, labels, weights),
        "AuPR": aupr(scores, labels, weights),
        "Precision": precision,
        "Recall": recall,
        "F1": f1,
        "Error": (fp + fn) / tot,
        "TP": tp, "FP": fp, "FN": fn, "TN": tn,
        "BrierScore": torch.sum(w * (scores - y) ** 2) / tot,
        "LogLoss": -torch.sum(w * (y * torch.log(s)
                                   + (1 - y) * torch.log(1 - s))) / tot,
    }


def _linspace01(num: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, num)`` bit for bit: XLA computes the f32
    iota times the f32 reciprocal of num - 1, then appends 1."""
    if num == 1:
        return torch.zeros(1, device=device)
    recip = torch.tensor(1.0, dtype=torch.float32) / float(num - 1)
    head = torch.arange(num - 1, dtype=torch.float32) * recip
    return torch.cat([head, torch.ones(1)]).to(device)


def threshold_curves(scores: torch.Tensor, labels: torch.Tensor,
                     weights: Optional[torch.Tensor] = None,
                     num_thresholds: int = 100) -> Dict[str, torch.Tensor]:
    """P/R/F1 at evenly spaced thresholds."""
    thresholds = _linspace01(num_thresholds, scores.device)
    w = _w(weights, scores)
    y = labels.to(torch.float32)
    pred = (scores[None, :] >= thresholds[:, None]).to(torch.float32)
    tp = torch.sum(w * pred * y, dim=1)
    fp = torch.sum(w * pred * (1 - y), dim=1)
    fn = torch.sum(w * (1 - pred) * y, dim=1)
    p = tp / torch.clamp(tp + fp, min=EPS)
    r = tp / torch.clamp(tp + fn, min=EPS)
    return {"thresholds": thresholds, "precisionByThreshold": p,
            "recallByThreshold": r,
            "f1ByThreshold": 2 * p * r / torch.clamp(p + r, min=EPS)}


# ---------------------------------------------------------------------------
# Multiclass
# ---------------------------------------------------------------------------

def multiclass_confusion(probs: torch.Tensor, labels: torch.Tensor,
                         weights: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(n, k) probs + (n,) int labels -> (k, k) weighted confusion matrix
    [true, pred]."""
    k = probs.shape[1]
    pred = torch.argmax(probs, dim=1)
    w = _w(weights, labels.to(torch.float32))
    true_oh = _one_hot(labels, k) * w[:, None]
    pred_oh = _one_hot(pred, k)
    return (true_oh[:, :, None] * pred_oh[:, None, :]).sum(0)


def multiclass_metrics(probs: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    cm = multiclass_confusion(probs, labels, weights)
    tp = torch.diagonal(cm)
    row = torch.sum(cm, dim=1)  # true counts
    col = torch.sum(cm, dim=0)  # predicted counts
    tot = torch.clamp(torch.sum(cm), min=EPS)
    per_p = tp / torch.clamp(col, min=EPS)
    per_r = tp / torch.clamp(row, min=EPS)
    per_f1 = 2 * per_p * per_r / torch.clamp(per_p + per_r, min=EPS)
    present = (row > 0).to(torch.float32)
    n_present = torch.clamp(torch.sum(present), min=1.0)
    micro_tp = torch.sum(tp)
    w = _w(weights, labels.to(torch.float32))
    p = torch.clamp(probs, EPS, 1.0)
    true_oh = _one_hot(labels, probs.shape[1])
    logloss = -torch.sum(w * torch.sum(true_oh * torch.log(p), dim=1)) / tot
    return {
        "Error": 1.0 - micro_tp / tot,
        "Precision": micro_tp / tot,   # micro precision == accuracy
        "Recall": micro_tp / tot,
        "F1": micro_tp / tot,
        "macroPrecision": torch.sum(per_p * present) / n_present,
        "macroRecall": torch.sum(per_r * present) / n_present,
        "macroF1": torch.sum(per_f1 * present) / n_present,
        "LogLoss": logloss,
        "confusion": cm,
    }


def multiclass_topk_threshold_metrics(
        probs: torch.Tensor, labels: torch.Tensor,
        weights: Optional[torch.Tensor] = None,
        topns: Tuple[int, ...] = (1, 3),
        num_thresholds: int = 20) -> Dict[str, torch.Tensor]:
    """OpMultiClassificationEvaluator's ThresholdMetrics: for each topN
    and confidence threshold over the max class probability, the
    weighted fraction correct (true label in the top N, confident),
    incorrect (confident, label outside the top N) and without a
    prediction (max probability under the threshold). A label outside
    0..k-1 ranks beyond every topN. Shapes (len(topns), num_thresholds)."""
    w = _w(weights, labels.to(torch.float32))
    tot = torch.clamp(torch.sum(w), min=EPS)
    k = probs.shape[1]
    order = torch.argsort(-probs, dim=1, stable=True)
    match = order == labels.to(torch.int64)[:, None]
    rank = torch.where(match.any(dim=1),
                       torch.argmax(match.to(torch.int32), dim=1),
                       torch.full_like(labels, k, dtype=torch.int64))
    maxp = torch.max(probs, dim=1).values
    thresholds = _linspace01(num_thresholds, probs.device)
    topn = torch.as_tensor(topns, dtype=torch.int64, device=probs.device)
    confident = (maxp[None, :] >= thresholds[:, None]).to(torch.float32) * w
    in_topn = (rank[None, :] < topn[:, None]).to(torch.float32)   # (T, n)
    correct = (in_topn[:, None, :] * confident[None]).sum(-1) / tot
    incorrect = ((1.0 - in_topn)[:, None, :] * confident[None]).sum(-1) / tot
    nopred = (1.0 - confident.sum(-1) / tot)[None, :].expand_as(correct)
    return {"topNs": topn.to(torch.int32), "thresholds": thresholds,
            "correctCounts": correct, "incorrectCounts": incorrect,
            "noPredictionCounts": nopred.contiguous()}


# ---------------------------------------------------------------------------
# Regression
# ---------------------------------------------------------------------------

def regression_metrics(pred: torch.Tensor, target: torch.Tensor,
                       weights: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    w = _w(weights, pred)
    tot = torch.clamp(torch.sum(w), min=EPS)
    err = pred - target
    mse = torch.sum(w * err ** 2) / tot
    mean_t = torch.sum(w * target) / tot
    ss_tot = torch.sum(w * (target - mean_t) ** 2) / tot
    return {
        "RootMeanSquaredError": torch.sqrt(mse),
        "MeanSquaredError": mse,
        "MeanAbsoluteError": torch.sum(w * torch.abs(err)) / tot,
        "R2": 1.0 - mse / torch.clamp(ss_tot, min=EPS),
        "SignedPercentageErrorMean": torch.sum(
            w * 100.0 * err / torch.clamp(torch.abs(target), min=EPS)) / tot,
    }
