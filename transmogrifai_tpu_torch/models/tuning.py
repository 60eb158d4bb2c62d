"""Validation & data-prep: CV / train-validation split, splitters.

Counterpart of ``transmogrifai_tpu/models/tuning.py`` (reference:
tuning/ — OpValidator, OpCrossValidation, OpTrainValidationSplit,
DataSplitter, DataBalancer, DataCutter). Folds and class balance are
sample-weight vectors, never row resampling, so every (fold x hyper)
instance of a family shares one shape and the whole grid is one batch.

What the port carries: the splitters and fold masks (numpy, copied),
the (fold x grid) batch layout, the validation metrics, and the FOLDED
path — a family with ``fit_eval_grid`` (the tree families) fits its
whole batch in one call whose tree levels are one histogram launch
each. On one device; PyTorch runs eagerly, so a dispatch runs when its
batch is first collected, and a CUDA out-of-memory there re-runs the
batch in 2, 4, then 8 sequential chunks (the JAX package's halving on
XLA's RESOURCE_EXHAUSTED).

Not carried over: the vmapped sweep of the linear families (a family
without ``fit_eval_grid`` raises), ``TM_TREE_GRID_FOLD=0`` (the port has
only the folded path, so the knob raises), the serial sweep of
``TM_SWEEP_FUSION=0`` (an instance's fit does not depend on its batch,
so stacking candidates changes no result), grid sharding over a device
mesh (``TM_MESH_AXIS=grid,data``, the 2-D sweep, raises), static hyper
specialization and gathered-fold slicing (tree families use neither),
the program caches (nothing is traced) and the fault points.
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..evaluators import functional as F
from .base import ModelFamily

RANDOM_SEED = 42


def require_folded(family: ModelFamily) -> None:
    """Raise unless ``family`` validates on the folded path (the only
    validation path this slice of the port carries)."""
    if not hasattr(family, "fit_eval_grid"):
        raise NotImplementedError(
            f"model family {family.name!r} is not ported in this slice: "
            f"the port validates families with a folded grid fit (the "
            f"tree families) only")
    if os.environ.get("TM_TREE_GRID_FOLD", "1") == "0":
        raise NotImplementedError(
            "TM_TREE_GRID_FOLD=0 (the vmapped per-instance tree path) is "
            "not ported: transmogrifai_tpu_torch has only the folded path")
    from ..parallel.mesh import resolve_mesh_config
    if resolve_mesh_config().axis == "grid,data":
        raise NotImplementedError(
            "TM_MESH_AXIS=grid,data (the 2-D grid x data sweep) is not "
            "ported: the port's row-partitioned path is "
            "trees.grow_tree_grid(mesh=...) and parallel.sharded_histograms")


# ---------------------------------------------------------------------------
# Splitters (data prep before validation) — numpy, as in the JAX package
# ---------------------------------------------------------------------------

@dataclass
class SplitterSummary:
    name: str
    details: Dict[str, Any] = field(default_factory=dict)

    def to_json(self):
        return {"name": self.name, **self.details}


class DataSplitter:
    """Random train/holdout split (regression default).

    Reference: tuning/DataSplitter.scala.
    """

    def __init__(self, reserve_fraction: float = 0.1, seed: int = RANDOM_SEED,
                 max_training_sample: int = 1_000_000):
        self.reserve_fraction = reserve_fraction
        self.seed = seed
        self.max_training_sample = max_training_sample

    def split(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(n)
        n_hold = int(round(n * self.reserve_fraction))
        train = perm[n_hold:][: self.max_training_sample]
        return np.sort(train), np.sort(perm[:n_hold])

    def prepare(self, y: np.ndarray) -> Tuple[np.ndarray, SplitterSummary]:
        """Return per-row weights (1.0) — no balancing for plain splits."""
        return np.ones_like(y, dtype=np.float32), SplitterSummary(
            "DataSplitter", {"reserveFraction": self.reserve_fraction})


class DataBalancer(DataSplitter):
    """Binary-label balancing by weights (reference:
    tuning/DataBalancer.scala): ``mode="reweight"`` gives fractional
    class weights whose weighted label fraction equals the target;
    ``mode="resample"`` a seeded Poisson realization of them."""

    def __init__(self, sample_fraction: float = 0.1,
                 max_training_sample: int = 1_000_000,
                 reserve_fraction: float = 0.1, seed: int = RANDOM_SEED,
                 mode: str = "reweight"):
        super().__init__(reserve_fraction, seed, max_training_sample)
        if mode not in ("reweight", "resample"):
            raise ValueError(f"unknown balancer mode {mode!r}")
        self.sample_fraction = sample_fraction
        self.mode = mode

    def prepare(self, y: np.ndarray) -> Tuple[np.ndarray, SplitterSummary]:
        y = y.astype(np.float32)
        n = len(y)
        n_pos = float(y.sum())
        n_neg = n - n_pos
        frac_pos = n_pos / max(n, 1)
        w = np.ones(n, dtype=np.float32)
        target = self.sample_fraction
        balanced = False
        if 0 < n_pos < n and frac_pos < target:
            w_pos = target * n_neg / ((1.0 - target) * n_pos)
            w = np.where(y > 0.5, w_pos, 1.0).astype(np.float32)
            balanced = True
        elif 0 < n_pos < n and (1.0 - frac_pos) < target:
            w_neg = target * n_pos / ((1.0 - target) * n_neg)
            w = np.where(y < 0.5, w_neg, 1.0).astype(np.float32)
            balanced = True
        if balanced and self.mode == "resample":
            rng = np.random.default_rng(self.seed)
            w = np.where(w == 1.0, np.float32(1.0),
                         rng.poisson(w).astype(np.float32))
        return w, SplitterSummary("DataBalancer", {
            "positiveFraction": frac_pos, "sampleFraction": target,
            "balanced": balanced, "mode": self.mode})


class DataCutter(DataSplitter):
    """Multiclass rare-label handling: drop labels below minFraction or
    beyond maxClasses by zero-weighting their rows (reference:
    tuning/DataCutter.scala)."""

    def __init__(self, max_classes: int = 100, min_label_fraction: float = 0.0,
                 reserve_fraction: float = 0.1, seed: int = RANDOM_SEED):
        super().__init__(reserve_fraction, seed)
        self.max_classes = max_classes
        self.min_label_fraction = min_label_fraction

    def prepare(self, y: np.ndarray) -> Tuple[np.ndarray, SplitterSummary]:
        labels, counts = np.unique(y.astype(np.int64), return_counts=True)
        frac = counts / max(len(y), 1)
        order = np.argsort(-counts)
        kept = [int(labels[i]) for i in order
                if frac[i] >= self.min_label_fraction][: self.max_classes]
        kept_set = set(kept)
        w = np.isin(y.astype(np.int64),
                    np.asarray(kept, dtype=np.int64)).astype(np.float32)
        return w, SplitterSummary("DataCutter", {
            "labelsKept": sorted(kept_set),
            "labelsDropped": sorted(set(int(l) for l in labels) - kept_set)})


def make_splitter(spec, seed, default_kind: str = "splitter"):
    """Build a splitter from the selector-spec dict ({"type": "balancer"
    | "cutter" | "splitter", ...kwargs})."""
    s = dict(spec or {})
    kind = s.pop("type", default_kind)
    if kind not in ("balancer", "cutter", "splitter"):
        raise ValueError(f"unknown splitter type {kind!r}; one of "
                         f"'balancer', 'cutter', 'splitter'")
    s.setdefault("seed", seed)
    if kind == "balancer":
        return DataBalancer(**s)
    if kind == "cutter":
        return DataCutter(**s)
    return DataSplitter(**s)


# ---------------------------------------------------------------------------
# Fold construction
# ---------------------------------------------------------------------------

def make_fold_masks(n: int, n_folds: int, seed: int = RANDOM_SEED
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(n_folds, n) 0/1 train and validation masks."""
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, n_folds, size=n)
    val = np.stack([(assign == f).astype(np.float32) for f in range(n_folds)])
    return 1.0 - val, val


def build_fold_grid_batch(grid: Sequence[Dict[str, float]],
                          train_m: np.ndarray, val_m: np.ndarray):
    """The fold-major (fold x grid) batch for one family: masks use
    np.repeat (fold-major blocks of g grid points) while hypers use
    np.tile, so batch item f*g + j pairs fold f with grid point j.
    Returns (train_b, val_b, hyper_b) with leading dim n_folds * g."""
    g = len(grid)
    n_folds = train_m.shape[0]
    hyper_b = stack_hyper_batch(grid, n_folds)
    return (np.repeat(train_m, g, axis=0), np.repeat(val_m, g, axis=0),
            hyper_b)


def stack_hyper_batch(grid: Sequence[Dict[str, float]], n_folds: int
                      ) -> Dict[str, np.ndarray]:
    """The hyper half of build_fold_grid_batch's (fold x grid) layout."""
    hyper = ModelFamily.stack_grid(grid)
    return {k: np.tile(np.asarray(v), n_folds) for k, v in hyper.items()}


# ---------------------------------------------------------------------------
# Validation metrics: name -> (fn(probs, y, w) -> scalar, larger_is_better)
# ---------------------------------------------------------------------------

def _mc_error(p, y, w):
    wrong = (torch.argmax(p, dim=1) != y.to(torch.int64)).to(torch.float32)
    return torch.sum(w * wrong) / torch.clamp(torch.sum(w), min=1e-12)


def _macro_f1(p, y, w):
    """Weighted macro F1 over classes present in the validation fold's
    truth OR predictions (sklearn's average='macro')."""
    k = p.shape[1]
    pred_oh = F._one_hot(torch.argmax(p, dim=1), k)
    true_oh = F._one_hot(y, k)
    wc = w[:, None]
    tp = torch.sum(wc * true_oh * pred_oh, dim=0)
    row = torch.sum(wc * true_oh, dim=0)
    col = torch.sum(wc * pred_oh, dim=0)
    eps = 1e-12
    per_p = tp / torch.clamp(col, min=eps)
    per_r = tp / torch.clamp(row, min=eps)
    per_f1 = 2 * per_p * per_r / torch.clamp(per_p + per_r, min=eps)
    present = ((row > 0) | (col > 0)).to(torch.float32)
    return torch.sum(per_f1 * present) / torch.clamp(torch.sum(present),
                                                     min=1.0)


def _logloss(p, y, w):
    pc = torch.clamp(p, 1e-12, 1.0)
    nll = -torch.sum(F._one_hot(y, p.shape[1]) * torch.log(pc), dim=1)
    return torch.sum(w * nll) / torch.clamp(torch.sum(w), min=1e-12)


def _brier(p, y, w):
    """Binary: (p1 - y)^2; multiclass: the full one-hot quadratic."""
    if p.shape[1] == 2:
        sq = (p[:, 1] - y) ** 2
    else:
        sq = torch.sum((p - F._one_hot(y, p.shape[1])) ** 2, dim=1)
    return torch.sum(w * sq) / torch.clamp(torch.sum(w), min=1e-12)


def _w_mse(pred, y, w):
    return torch.sum(w * (pred - y) ** 2) / torch.clamp(torch.sum(w),
                                                        min=1e-12)


def _w_r2(pred, y, w):
    sw = torch.clamp(torch.sum(w), min=1e-12)
    mean_y = torch.sum(w * y) / sw
    ss_tot = torch.sum(w * (y - mean_y) ** 2) / sw
    return 1.0 - _w_mse(pred, y, w) / torch.clamp(ss_tot, min=1e-12)


_METRIC_FNS: Dict[str, Tuple[Callable, bool]] = {
    "auroc": (lambda p, y, w: F.auroc(p[:, 1], y, w), True),
    "aupr": (lambda p, y, w: F.aupr(p[:, 1], y, w), True),
    "error": (lambda p, y, w: _mc_error(p, y, w), False),
    "accuracy": (lambda p, y, w: 1.0 - _mc_error(p, y, w), True),
    "microf1": (lambda p, y, w: 1.0 - _mc_error(p, y, w), True),
    "f1": (lambda p, y, w: 1.0 - _mc_error(p, y, w), True),
    "macrof1": (lambda p, y, w: _macro_f1(p, y, w), True),
    "logloss": (lambda p, y, w: _logloss(p, y, w), False),
    "brier": (lambda p, y, w: _brier(p, y, w), False),
    "rmse": (lambda p, y, w: torch.sqrt(_w_mse(p[:, 0], y, w)), False),
    "r2": (lambda p, y, w: _w_r2(p[:, 0], y, w), True),
}


# ---------------------------------------------------------------------------
# Dispatch and collect
# ---------------------------------------------------------------------------

def _is_retryable_device_error(e: BaseException) -> bool:
    """Out-of-memory failures worth a smaller re-dispatch (reference
    analog: Spark task retry). A host-side error that merely mentions
    memory must surface, not loop."""
    return isinstance(e, torch.cuda.OutOfMemoryError)


def _chunked_retry(run: Callable, train_b, val_b, hyper_b,
                   n_chunks: int) -> np.ndarray:
    """Sequential chunked re-dispatch of a batch -> metrics np array."""
    b = train_b.shape[0]
    step = max(1, -(-b // n_chunks))
    mets = []
    for s in range(0, b, step):
        sl = slice(s, s + step)
        mets.append(run(train_b[sl], val_b[sl],
                        {k: v[sl] for k, v in hyper_b.items()}))
    return np.concatenate(mets)


class _SweepBatch:
    """One family's (fold x combined-grid) batch. Runs at its first
    materialize (PyTorch is eager: there is no compiled program to
    queue), with the chunk-halving retry on a CUDA out-of-memory; every
    candidate sliced out of it shares the one result. ``seconds`` is
    the wall of that run, host clock, ending in the metrics' copy to
    the host (which waits for the device)."""

    def __init__(self, family: str, n_folds: int, grid_total: int,
                 run: Callable, train_b, val_b, hyper_b):
        self.family = family
        self.n_folds = int(n_folds)
        self.grid_total = int(grid_total)
        self._args = (run, train_b, val_b, hyper_b)
        self.seconds: Optional[float] = None
        self._metrics_np: Optional[np.ndarray] = None
        self._lock = threading.Lock()

    def materialize(self) -> np.ndarray:
        with self._lock:
            if self._metrics_np is not None:
                return self._metrics_np
            run, tb, vb, hb = self._args
            t0 = time.perf_counter()
            try:
                metrics = run(tb, vb, hb)
            except Exception as e:
                if not _is_retryable_device_error(e):
                    raise
                metrics = self._retry(e)
            self.seconds = time.perf_counter() - t0
            self._metrics_np = metrics
            return metrics

    def _retry(self, first: BaseException) -> np.ndarray:
        run, tb, vb, hb = self._args
        last = first
        for k in (2, 4, 8):
            torch.cuda.empty_cache()
            try:
                return _chunked_retry(run, tb, vb, hb, k)
            except Exception as e:  # keep halving while retryable
                if not _is_retryable_device_error(e):
                    raise
                last = e
        raise RuntimeError(f"{self.family}: sweep batch failed even at "
                           f"1/8 batch") from last


@dataclass
class PendingValidation:
    """A dispatched (fold x grid) validation batch for one candidate: a
    (grid_offset, len(grid)) column slice of its family's _SweepBatch.
    Collect with the OpValidator that dispatched it."""
    family: str
    grid: List[Dict[str, float]]
    batch: _SweepBatch
    grid_offset: int = 0


@dataclass
class ValidationResult:
    family: str
    grid: List[Dict[str, float]]
    metric_name: str
    larger_is_better: bool
    #: (n_grid,) mean metric across folds
    grid_metrics: np.ndarray
    best_index: int

    @property
    def best_hyper(self) -> Dict[str, float]:
        return self.grid[self.best_index]

    @property
    def best_metric(self) -> float:
        return float(self.grid_metrics[self.best_index])

    def to_json(self):
        return {"family": self.family, "metric": self.metric_name,
                "grid": self.grid,
                "gridMetrics": [float(m) for m in self.grid_metrics],
                "bestIndex": self.best_index, "bestHyper": self.best_hyper,
                "bestMetric": self.best_metric}


class OpValidator:
    """Shared validation loop: fit the (fold x grid) batch of one
    family as a single folded call and aggregate per-grid-point
    metrics."""

    def __init__(self, metric: str, seed: int = RANDOM_SEED):
        if metric not in _METRIC_FNS:
            raise ValueError(f"unknown validation metric {metric!r}; "
                             f"one of {sorted(_METRIC_FNS)}")
        self.metric = metric
        self.seed = seed

    @property
    def larger_is_better(self) -> bool:
        return _METRIC_FNS[self.metric][1]

    def _masks(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    @staticmethod
    def _folded_runner(family: ModelFamily, metric_fn, n_classes: int,
                       repl) -> Callable:
        """Runner of the folded path: the batch folds into the tree
        kernels' own instance axis (one histogram launch per level for
        the whole batch). Host mask/hyper batches go to the device of
        the replicated (X, y, w); returns (b,) host metrics."""
        Xt, yt, wt = repl

        def run(tr, va, hy):
            dev = Xt.device

            def put(a):
                return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                       device=dev)

            with torch.inference_mode():
                out = family.fit_eval_grid(
                    Xt, yt, wt, put(tr), put(va),
                    {k: put(v) for k, v in hy.items()}, n_classes,
                    metric_fn)
                return out.cpu().numpy()

        return run

    @staticmethod
    def _device_data(X, y, base_w, device):
        return (torch.as_tensor(np.asarray(X, np.float32), device=device),
                torch.as_tensor(np.asarray(y, np.float32), device=device),
                torch.as_tensor(np.asarray(base_w, np.float32),
                                device=device))

    def dispatch(self, family: ModelFamily, grid: List[Dict[str, float]],
                 X: np.ndarray, y: np.ndarray, base_w: np.ndarray,
                 n_classes: int, device) -> PendingValidation:
        """One candidate's (fold x grid) batch on ``device``; it runs
        when collected."""
        return self.dispatch_many([("_", family, grid)], X, y, base_w,
                                  n_classes, device)["_"]

    def dispatch_many(self, entries: Sequence[Tuple[str, ModelFamily,
                                                    List[Dict[str, float]]]],
                      X: np.ndarray, y: np.ndarray, base_w: np.ndarray,
                      n_classes: int, device
                      ) -> Dict[str, PendingValidation]:
        """The fused sweep: every candidate of one family (sharing a
        hyper key set) stacks into ONE batch (folds x concatenated
        grids). ``entries`` is [(key, family, grid), ...] in candidate
        order; returns {key: PendingValidation}, each a column slice of
        its group's shared batch."""
        for _key, fam, _grid in entries:
            require_folded(fam)
        train_m, val_m = self._masks(len(y))
        n_folds = train_m.shape[0]
        repl = self._device_data(X, y, base_w, device)
        metric_fn, _ = _METRIC_FNS[self.metric]

        groups: "OrderedDict[Tuple[str, Tuple], List[int]]" = OrderedDict()
        for i, (_key, fam, grid) in enumerate(entries):
            hyper_keys = tuple(sorted(grid[0])) if grid else ()
            groups.setdefault((fam.name, hyper_keys), []).append(i)

        out: Dict[str, PendingValidation] = {}
        for idxs in groups.values():
            fam = entries[idxs[0]][1]
            combined: List[Dict[str, float]] = []
            offsets: List[int] = []
            for i in idxs:
                offsets.append(len(combined))
                combined.extend(entries[i][2])
            run = self._folded_runner(fam, metric_fn, n_classes, repl)
            train_b, val_b, hyper_b = build_fold_grid_batch(
                combined, train_m, val_m)
            batch = _SweepBatch(fam.name, n_folds, len(combined), run,
                                train_b, val_b, hyper_b)
            for i, off in zip(idxs, offsets):
                key, _, grid = entries[i]
                out[key] = PendingValidation(fam.name, grid, batch,
                                             grid_offset=off)
        return out

    def collect(self, pending: PendingValidation) -> ValidationResult:
        g = len(pending.grid)
        b = pending.batch
        metrics = b.materialize().reshape(b.n_folds, b.grid_total)[
            :, pending.grid_offset:pending.grid_offset + g]
        mean = np.nanmean(metrics, axis=0)
        best = int(np.nanargmax(mean) if self.larger_is_better
                   else np.nanargmin(mean))
        return ValidationResult(
            family=pending.family, grid=pending.grid,
            metric_name=self.metric,
            larger_is_better=self.larger_is_better, grid_metrics=mean,
            best_index=best)

    def validate(self, family: ModelFamily, grid: List[Dict[str, float]],
                 X: np.ndarray, y: np.ndarray, base_w: np.ndarray,
                 n_classes: int, device) -> ValidationResult:
        return self.collect(self.dispatch(family, grid, X, y, base_w,
                                          n_classes, device))


class OpCrossValidation(OpValidator):
    """K-fold CV (reference: OpCrossValidation.scala)."""

    def __init__(self, n_folds: int = 3, metric: str = "auroc",
                 seed: int = RANDOM_SEED):
        super().__init__(metric, seed)
        self.n_folds = n_folds

    def _masks(self, n):
        return make_fold_masks(n, self.n_folds, self.seed)

    def to_json(self):
        return {"type": "crossValidation", "folds": self.n_folds,
                "metric": self.metric, "seed": self.seed}


class OpTrainValidationSplit(OpValidator):
    """Single train/validation split (reference:
    OpTrainValidationSplit.scala)."""

    def __init__(self, train_ratio: float = 0.75, metric: str = "auroc",
                 seed: int = RANDOM_SEED):
        super().__init__(metric, seed)
        self.train_ratio = train_ratio

    def _masks(self, n):
        rng = np.random.default_rng(self.seed)
        train = (rng.random(n) < self.train_ratio).astype(np.float32)[None, :]
        return train, 1.0 - train

    def to_json(self):
        return {"type": "trainValidationSplit", "trainRatio": self.train_ratio,
                "metric": self.metric, "seed": self.seed}
