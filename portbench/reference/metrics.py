"""Evaluation metrics in float64."""
from __future__ import annotations

import torch


def auroc(scores: torch.Tensor, labels: torch.Tensor,
          weights: torch.Tensor) -> float:
    """Weighted area under the ROC curve, ties counted half (the
    Mann-Whitney statistic), in float64."""
    s = scores.to(torch.float64)
    y = labels.to(torch.float64)
    w = weights.to(torch.float64)
    s, order = torch.sort(s, stable=True)
    pos = (w * y)[order]
    neg = (w * (1 - y))[order]
    cn = torch.cat([torch.zeros(1, dtype=torch.float64, device=s.device),
                    torch.cumsum(neg, 0)])
    lo = torch.searchsorted(s, s, side="left")
    hi = torch.searchsorted(s, s, side="right")
    num = torch.sum(pos * (cn[lo] + 0.5 * (cn[hi] - cn[lo])))
    den = torch.sum(pos) * torch.sum(neg)
    return float(num / torch.clamp(den, min=1e-300))


def logloss(scores: torch.Tensor, labels: torch.Tensor,
            eps: float = 1e-12) -> float:
    """Mean binary log loss of P(label 1) scores clamped to [eps, 1-eps],
    in float64."""
    s = torch.clamp(scores.to(torch.float64), eps, 1 - eps)
    y = labels.to(torch.float64)
    return float(-(y * torch.log(s) + (1 - y) * torch.log(1 - s)).mean())
