"""How ``correct`` is decided for a selector cell: the fitted selector's
outputs (its per-grid-point CV metrics, the fold fits behind them, its
winner, the winner's refit, its holdout metric) held against the plain
reference in ``reference/``, each number beside its limit from
``limits/<cell>.json``.

The numbers, each the widest over what it covers:

* ``cv_gap`` — every linear family's per-grid-point CV AUROC against the
  reference's own fits of each fold (float64), absolute;
* ``tree_cv_gap`` — every tree family's per-grid-point CV AUROC against
  the reference's AUROC of the program's own fold fits (read where the
  selector's cross-validation makes them), scored on the reference's
  validation folds, absolute;
* ``winner_gap`` — the best per-grid-point CV metric the program reports
  less the one it reports for its winner: an exact comparison (the two
  above hold the reported metrics to the reference's);
* ``refit_gap`` — a linear winner's refit parameters against the
  reference's fit of the training split, relative to each array's
  largest entry;
* ``split_loss`` — every tree fit (each fold's fit of each grid point,
  and a tree winner's refit), replayed over its training rows: the most
  gain a node's chosen split gives up against the best allowed
  candidate, as a share of its tree's root gain (reference/trees.py);
* ``leaf_gap`` — their leaf values (and a boosted base margin) against
  G/(H+lam) of the rows each leaf holds: the row-weighted root mean
  square error relative to that of the values, the worst tree;
* ``holdout_logloss_gap`` — the program's holdout log loss against the
  reference's log loss of the refit's scores of the holdout rows,
  relative (every score counts);
* ``holdout_auroc_gap`` — the same for the holdout AUROC, absolute (it
  reads only the scores' order).

For the CTR selector (:func:`judge_sparse`): ``sweep_loss_gap``, every
grid point's validation log loss against the reference's sweep over the
same stream (relative); ``refit_gap``, the winner's refit weights against
the reference's refit; and the two holdout numbers.

A cell's limits file names every number its fits can give: a limit, or
null for a number read but not compared there (its control does not
separate from the program on it; ``PERF.md`` gives the readings).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .costs import SPARSE_LABELS
from .reference import linear, metrics, sparse, split, trees
from .reference.precision import OPERAND

#: the control's precisions, each one below the configuration's: the
#: tree histograms' operands in float8 (bf16 stated), the linear fits'
#: and the tree leaves' sums' products in TF32 (f32 with TF32 off
#: stated), the CV and holdout scores in bf16 (f32 stated)
CONTROL_TREE_OPERAND = "fp8"
CONTROL_LINEAR = "tf32"
CONTROL_LEAF = "tf32"
CONTROL_SCORE = "bf16"


def _fold_cv(family, grid, X, y, w, fold, folds, prec) -> List[float]:
    """Mean CV AUROC of each grid point of a linear family."""
    out = []
    for hyper in grid:
        aucs = []
        for f in range(folds):
            tr, va = fold != f, fold == f
            p = linear.fit(family, hyper, X[tr], y[tr], w[tr], prec)
            s = linear.score(family, p, X[va])
            aucs.append(metrics.auroc(s, y[va], w[va]))
        out.append(float(np.mean(aucs)))
    return out


def _refit_gap(got: Mapping[str, torch.Tensor],
               want: Mapping[str, torch.Tensor]) -> float:
    gap = 0.0
    for k, v in want.items():
        v = v.to(torch.float64)
        g = got[k].to(v.device, torch.float64)
        gap = max(gap, float((g - v).abs().max())
                  / max(float(v.abs().max()), 1e-12))
    return gap


class Rows:
    """The cell's rows as the selector prepares them: the training split
    on the device, its balancing weights and fold ids, the holdout."""

    def __init__(self, X: np.ndarray, y: np.ndarray, folds: int, device):
        tr, ho = split.train_holdout(len(y))
        self.folds = folds
        dev = torch.device(device)
        self.X = torch.from_numpy(np.ascontiguousarray(X[tr])).to(dev)
        self.y = torch.from_numpy(y[tr].astype(np.float32)).to(dev)
        self.w = torch.from_numpy(split.balance_weights(y[tr])).to(dev)
        self.fold = torch.from_numpy(split.fold_ids(len(tr), folds)).to(dev)
        self.Xh = torch.from_numpy(np.ascontiguousarray(X[ho])).to(dev)
        self.yh = torch.from_numpy(y[ho].astype(np.float32)).to(dev)


def reference_cv(rows: Rows, validation: Sequence[Mapping],
                 prec: str = "f64") -> Dict[str, List[float]]:
    """The reference's per-grid-point CV AUROC of each linear family."""
    return {r["family"]: _fold_cv(r["family"], r["grid"], rows.X, rows.y,
                                  rows.w, rows.fold, rows.folds, prec)
            for r in validation if r["family"] in linear.FAMILIES}


def _sweep_params(fits: Sequence[Mapping]) -> Dict[str, torch.Tensor]:
    """A family's fold fits as one batch (a batch the program retried in
    chunks arrives in its chunks, in order)."""
    return {k: torch.cat([torch.as_tensor(f[k]) for f in fits])
            for k in fits[0]}


def _grid_index(validation: Sequence[Mapping], best: Mapping
                ) -> Optional[int]:
    """The index of the winner's hyper in its family's grid."""
    for r in validation:
        if r["family"] != best["family"]:
            continue
        for j, point in enumerate(r["grid"]):
            if all(abs(float(best["hyper"].get(k, math.nan)) - float(v))
                   <= 1e-6 * max(1.0, abs(float(v)))
                   for k, v in point.items()):
                return j
    return None


def score(family: str, hyper, params, X) -> torch.Tensor:
    if family in trees.FAMILY:
        return trees.score(family, hyper, params, X)
    return linear.score(family, params, X)


def judge(rows: Rows, summary: Mapping, params: Mapping[str, torch.Tensor],
          sweep: Mapping[str, Sequence[Mapping]]) -> Dict[str, float]:
    """Every number this fit's outputs give (see the module docstring);
    ``sweep`` holds each tree family's fold fits as the selector's
    cross-validation made them."""
    out: Dict[str, float] = {}
    vr = summary["validationResults"]
    ref_cv = reference_cv(rows, vr)
    if ref_cv:
        out["cv_gap"] = max(
            abs(a - b) for r in vr if r["family"] in ref_cv
            for a, b in zip(r["gridMetrics"], ref_cv[r["family"]]))
    tree_rep: Dict[str, float] = {}
    for r in vr:
        fam = r["family"]
        if fam not in trees.FAMILY:
            continue
        if not sweep.get(fam):
            out["tree_cv_gap"] = math.inf
            continue
        rep, cv = trees.sweep(fam, r["grid"], rows.X, rows.y, rows.w,
                              rows.fold, rows.folds,
                              params=_sweep_params(sweep[fam]))
        for k in ("split_loss", "leaf_gap"):
            tree_rep[k] = max(tree_rep.get(k, 0.0), rep[k])
        out["tree_cv_gap"] = max(out.get("tree_cv_gap", 0.0), max(
            abs(a - b) for a, b in zip(r["gridMetrics"], cv)))
    best = summary["bestModel"]
    family, hyper = best["family"], best["hyper"]
    j = _grid_index(vr, best)
    won = [r["gridMetrics"][j] for r in vr if r["family"] == family]
    out["winner_gap"] = (max(v for r in vr for v in r["gridMetrics"])
                         - won[0] if won and j is not None else math.inf)
    dev = rows.X.device
    params = {k: torch.as_tensor(v).to(dev) for k, v in params.items()}
    if family in trees.FAMILY:
        rep = trees.run(family, hyper, rows.X, rows.y, rows.w, params=params)
        for k in ("split_loss", "leaf_gap"):
            tree_rep[k] = max(tree_rep.get(k, 0.0), rep[k])
    else:
        want = linear.fit(family, hyper, rows.X, rows.y, rows.w)
        out["refit_gap"] = _refit_gap(params, want)
    out.update(tree_rep)
    s = score(family, hyper, params, rows.Xh)
    ev = summary["holdoutEvaluation"]
    ll = metrics.logloss(s, rows.yh)
    out["holdout_logloss_gap"] = abs(float(ev["LogLoss"]) - ll) / ll
    auc = metrics.auroc(s, rows.yh, torch.ones_like(rows.yh))
    out["holdout_auroc_gap"] = abs(float(ev["AuROC"]) - auc)
    return out


def control_fit(rows: Rows, summary: Mapping):
    """The reference put in the program's place one precision below the
    configuration's (the ``CONTROL_*`` precisions): the same families and
    grids; each linear grid point's fold fits, each tree family's fold
    fits (scored in bf16), the winner (the grid point of the best CV
    metric) and its refit are the reference's own. Returns (summary,
    refit params, tree fold fits) shaped as the program's."""
    vr = []
    ctl_cv = reference_cv(rows, summary["validationResults"], CONTROL_LINEAR)
    sweep: Dict[str, List[Mapping]] = {}
    for r in summary["validationResults"]:
        r = dict(r)
        fam = r["family"]
        if fam in ctl_cv:
            r["gridMetrics"] = ctl_cv[fam]
        elif fam in trees.FAMILY:
            p, r["gridMetrics"] = trees.sweep(
                fam, r["grid"], rows.X, rows.y, rows.w, rows.fold,
                rows.folds, operand=CONTROL_TREE_OPERAND,
                leaf_operand=CONTROL_LEAF, dtype=torch.float32,
                score_operand=CONTROL_SCORE)
            sweep[fam] = [p]
        vr.append(r)
    top = max(vr, key=lambda r: max(r["gridMetrics"]))
    family = top["family"]
    hyper = top["grid"][int(np.argmax(top["gridMetrics"]))]
    best = {"family": family, "hyper": hyper}
    if family in trees.FAMILY:
        params = trees.run(family, hyper, rows.X, rows.y, rows.w,
                           operand=CONTROL_TREE_OPERAND,
                           leaf_operand=CONTROL_LEAF, dtype=torch.float32)
    else:
        params = linear.fit(family, hyper, rows.X, rows.y, rows.w,
                            CONTROL_LINEAR)
    s = OPERAND[CONTROL_SCORE](score(family, hyper, params, rows.Xh))
    ev = {"LogLoss": metrics.logloss(s, rows.yh),
          "AuROC": metrics.auroc(s, rows.yh, torch.ones_like(rows.yh))}
    return ({"validationResults": vr, "bestModel": best,
             "holdoutEvaluation": ev}, params, sweep)


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]
            ) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit, and whether all hold. A
    number the limits file names but this fit does not give (a tree
    winner has no refit_gap), or names with a null limit, is left out; a
    number the file does not name fails."""
    out = {}
    for k, v in numbers.items():
        if k in limits and limits[k] is None:
            continue
        lim = limits.get(k)
        out[k] = {"value": v, "limit": lim,
                  "ok": bool(lim is not None and math.isfinite(v)
                             and v <= lim)}
    return out


def all_ok(table: Mapping[str, Mapping]) -> bool:
    return bool(table) and all(r["ok"] for r in table.values())


class SparseRows:
    """The CTR selector's stream of training rows and its holdout."""

    def __init__(self, idx, num, y, st: Mapping, device):
        tr, ho = split.train_holdout(len(y))
        self.st, self.device = st, device
        self.B = None
        w = np.ones(len(tr), np.float32)
        self.chunks = sparse.stream(idx[tr], num[tr], y[tr], w,
                                    st["chunk_rows"], st["batch_size"],
                                    st["n_folds"], st["seed"])
        self.ho = (idx[ho], num[ho], torch.as_tensor(y[ho]).to(device))


def _sparse_fit(rows: SparseRows, summary, dtype, round_):
    """(validation losses in the summary's order, the winner's weights)."""
    st, dev = rows.st, rows.device
    vr = summary["validationResults"]
    by: Dict[str, List[int]] = {}
    for i, r in enumerate(vr):
        by.setdefault(SPARSE_LABELS[r["family"]], []).append(i)
    losses = [0.0] * len(vr)
    for fam, ii in by.items():
        ll = sparse.sweep(fam, [vr[i]["hyper"] for i in ii], rows.chunks,
                          rows.B, rows.d, st["fm_dim"], st["n_folds"],
                          st["epochs"], st["batch_size"], st["seed"],
                          dtype, dev, round_)
        for i, v in zip(ii, ll):
            losses[i] = v
    best = summary["bestModel"]
    W = sparse.refit(SPARSE_LABELS[best["family"]], best["hyper"],
                     rows.chunks, rows.B, rows.d, st["fm_dim"],
                     st["refit_epochs"], st["batch_size"], st["seed"],
                     dtype, dev, round_)
    return losses, W


def _holdout(rows: SparseRows, W, out, ev):
    s = sparse.score(W, rows.ho[0], rows.ho[1])
    y = rows.ho[2]
    ll = metrics.logloss(s, y)
    out["holdout_logloss_gap"] = abs(float(ev["LogLoss"]) - ll) / ll
    out["holdout_auroc_gap"] = abs(float(ev["AuROC"]) - metrics.auroc(
        s, y, torch.ones_like(y)))


def sparse_rows(idx, num, y, fit: Mapping, device) -> SparseRows:
    rows = SparseRows(idx, num, y, fit["stream"], device)
    rows.B, rows.d = fit["buckets"], fit["d"]
    return rows


def judge_sparse(idx, num, y, fit: Mapping, device) -> Dict[str, float]:
    """Every number a CTR selector fit's outputs give."""
    rows = sparse_rows(idx, num, y, fit, device)
    summary = fit["summary"]
    losses, W = _sparse_fit(rows, summary, torch.float64, None)
    out = {"sweep_loss_gap": max(
        abs(float(r["logloss"]) - l) / l
        for r, l in zip(summary["validationResults"], losses))}
    got = {k: torch.as_tensor(v).to(device) for k, v in fit["params"].items()}
    out["refit_gap"] = _refit_gap(got, W)
    _holdout(rows, {k: v.to(device) for k, v in got.items()}, out,
             summary["holdoutEvaluation"])
    return out


def control_sparse(idx, num, y, fit: Mapping, device):
    """The reference in the CTR selector's place with its optimizer state
    stored in bf16 (f32 stated), scored in bf16: a fit shaped as the
    program's."""
    rows = sparse_rows(idx, num, y, fit, device)
    summary = fit["summary"]
    losses, W = _sparse_fit(rows, summary, torch.float32,
                            OPERAND["bf16"])
    vr = [dict(r, logloss=l) for r, l in
          zip(summary["validationResults"], losses)]
    s = OPERAND["bf16"](sparse.score(W, rows.ho[0], rows.ho[1]))
    ev = {"LogLoss": metrics.logloss(s, rows.ho[2]),
          "AuROC": metrics.auroc(s, rows.ho[2], torch.ones_like(rows.ho[2]))}
    return dict(fit, summary={"validationResults": vr,
                              "bestModel": summary["bestModel"],
                              "holdoutEvaluation": ev},
                params={k: v.float() for k, v in W.items()})
