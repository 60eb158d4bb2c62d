"""Validation & data-prep: CV / train-validation split, splitters.

Counterpart of ``transmogrifai_tpu/models/tuning.py`` (reference:
tuning/ — OpValidator, OpCrossValidation, OpTrainValidationSplit,
DataSplitter, DataBalancer, DataCutter). Folds and class balance are
sample-weight vectors, never row resampling, so every (fold x hyper)
instance of a family shares one shape and the whole grid is one batch.

Two runners validate a family's (fold x grid) batch, on one device:

* the FOLDED path — a family with ``fit_eval_grid`` (the tree families)
  fits its whole batch in one call whose tree levels are one histogram
  launch each;
* the SWEEP — any other family (the linear ones): the batch's items are
  fitted through the family's ``fit_batch`` with an explicit leading
  item axis, in chunks of ``SWEEP_CHUNK`` items (the last one padded
  with copies of its first item), each item on its fold's gathered rows
  (``fold_slice_batch``; ``TM_SWEEP_FOLD_SLICE=0`` or
  ``TM_SWEEP_EXACT=1``: the full rows under a 0/1 weight mask), with a
  family's declared value-branching hypers passed as Python floats
  where they are constant across the group (``split_static_hyper``),
  and each item scored by ``predict_kernel``. Nothing in it reads the
  device on the host, so the card runs it while the host dispatches
  the next family.

Every batch is launched at dispatch and its metrics come to the host at
collect.

**Per-item independence** (what the selector's resume relies on: a
resumed fit re-dispatches a smaller batch and must reproduce the
uninterrupted one bit for bit): an item's metrics do not depend on the
batch's length or contents. JAX gets it from vmap. Here every chunk
has the same number of items and every item the same row count padded
to ``ROW_ALIGN`` (zero-weight rows), so each item runs the same kernels
on tensors of the same shape and alignment wherever it sits; on the CPU
a chunk holds one item (torch's CPU GEMMs and reductions round an
item by the batch around it). Static specialization and fold slicing
are float-level deviations from the masked traced program, as in the
JAX package (``sweep_exact``); a candidate's grouping depends only on
its own grid (``candidate_static_sig``).

A CUDA out-of-memory in a batch re-runs it: the folded batch in 2, 4,
then 8 sequential chunks, the sweep in chunks of a half, a quarter and
an eighth of ``SWEEP_CHUNK`` items (the JAX package's halving on XLA's
RESOURCE_EXHAUSTED; a re-run sweep item may differ from an un-retried
one in its last bits).

Not carried over: ``TM_TREE_GRID_FOLD=0`` (the vmapped per-instance
tree path raises), grid sharding over a device mesh
(``TM_MESH_AXIS=grid,data``, the 2-D sweep, raises) and the program
caches (nothing is traced, so ``SWEEP_STATS`` records no compiles).
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

from .._device import resolve_device
from ..evaluators import functional as F
from ..profiling import SWEEP_STATS
from ..resilience.faults import fault_point
from .base import ModelFamily, tree_map

RANDOM_SEED = 42

#: sweep modes accepted by TM_SWEEP_FUSION / resolve_sweep_mode
SWEEP_MODES = ("fused", "serial")

#: items one sweep chunk holds, by device type (see the module
#: docstring): one on the CPU, a fixed count on the card
SWEEP_CHUNK = {"cpu": 1, "cuda": 16}

#: a sweep item's rows are padded (zero weight) to a multiple of this,
#: so every item's rows start at the same alignment in a chunk; over
#: many rows to a multiple of the linear fits' Gram block instead
#: (``linear.GRAM_BLOCK``), which then needs no padding of its own
ROW_ALIGN = 32


def _row_align(n: int) -> int:
    from .linear import GRAM_BLOCK
    return GRAM_BLOCK if n >= 8 * GRAM_BLOCK else ROW_ALIGN


def resolve_sweep_mode(explicit: Optional[str] = None) -> str:
    """How the ModelSelector drives its candidate sweep: ``fused``
    (default) stacks all same-family candidates into one batch per
    family, with constant branch-selecting hypers specialized — in the
    sweep and in the winner's refit; ``serial`` (TM_SWEEP_FUSION=0) is
    one dispatch per candidate and the always-traced refit."""
    mode = explicit or os.environ.get("TM_SWEEP_FUSION") or "fused"
    mode = {"0": "serial", "off": "serial", "1": "fused",
            "on": "fused"}.get(mode, mode)
    if mode not in SWEEP_MODES:
        raise ValueError(f"unknown sweep mode {mode!r}; one of "
                         f"{SWEEP_MODES} (TM_SWEEP_FUSION)")
    return mode


def sweep_exact() -> bool:
    """TM_SWEEP_EXACT=1 keeps the fused sweep bitwise-exact against the
    serial validator: static specialization (which skips arithmetic the
    traced program runs as a no-op — the FISTA tail at
    elasticNetParam==0, the GLM's other solver) and fold slicing are
    off in the sweep and in the winner's refit."""
    return os.environ.get("TM_SWEEP_EXACT") == "1"


def fold_sliced() -> bool:
    """Gathered-fold sweep items: fit each (fold, grid point) on the
    fold's gathered train rows instead of the full rows under a
    zero-weight mask. Zero-weight rows add exact zeros to every weighted
    sum, so the optimum is unchanged and only the order of summation
    moves. On by default, off under TM_SWEEP_EXACT=1 or
    TM_SWEEP_FOLD_SLICE=0."""
    return (os.environ.get("TM_SWEEP_FOLD_SLICE", "1") != "0"
            and not sweep_exact())


def _validation_device(mesh, device) -> torch.device:
    """The device a validation batch runs on. The JAX signatures'
    ``mesh`` (grid sharding over a device mesh) is accepted as None
    only; ``device`` resolves as every entry point's does (None: CUDA,
    raising without a card)."""
    if mesh is not None:
        raise NotImplementedError(
            "OpValidator(mesh=...) (grid sharding over a device mesh) is "
            "not ported: the port validates on one device (device=)")
    return resolve_device(device)


def require_ported(family: ModelFamily) -> None:
    """Raise for the validation paths the port does not carry: the
    per-instance tree path (``TM_TREE_GRID_FOLD=0`` for a family with a
    folded fit) and the 2-D grid x data sweep (``TM_MESH_AXIS=grid,data``)."""
    if (hasattr(family, "fit_eval_grid")
            and os.environ.get("TM_TREE_GRID_FOLD", "1") == "0"):
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


def fold_slice_batch(train_m: np.ndarray, val_m: np.ndarray, g: int):
    """Gathered-fold variant of build_fold_grid_batch's mask layout: per
    fold the row indices where the mask is 1, padded to the widest fold
    (index 0, validity 0: a zero-weight duplicate of row 0), repeated
    fold-major like the masks (item f*g + j pairs fold f with grid point
    j). An item's content depends only on the fold masks, never on g.
    Returns ((tr_idx, tr_ok), (va_idx, va_ok)), each (n_folds * g, width)."""
    def pack(masks):
        idxs = [np.flatnonzero(m) for m in masks]
        width = max(1, max(len(i) for i in idxs))
        idx = np.zeros((len(idxs), width), np.int32)
        ok = np.zeros((len(idxs), width), np.float32)
        for f, i in enumerate(idxs):
            idx[f, :len(i)] = i
            ok[f, :len(i)] = 1.0
        return np.repeat(idx, g, axis=0), np.repeat(ok, g, axis=0)

    return pack(train_m), pack(val_m)


def split_static_hyper(family: ModelFamily, hyper_b: Dict[str, np.ndarray]
                       ) -> Tuple[Dict[str, np.ndarray], Tuple]:
    """Split a stacked hyper batch into (traced batch, static tuple): a
    key goes static when the family declares it value-branching
    (``static_hyper_keys``) and every item holds the same value. Off
    under TM_SWEEP_EXACT=1. One key stays traced when all would go."""
    keys = getattr(family, "static_hyper_keys", ())
    if not keys or sweep_exact():
        return hyper_b, ()
    traced: Dict[str, np.ndarray] = {}
    static: List[Tuple[str, float]] = []
    for k, v in hyper_b.items():
        arr = np.asarray(v)
        if k in keys and arr.size and np.all(arr == arr.flat[0]):
            static.append((k, float(arr.flat[0])))
        else:
            traced[k] = v
    if not traced:
        k, _ = static.pop()
        traced[k] = hyper_b[k]
    return traced, tuple(sorted(static))


def candidate_static_sig(family: ModelFamily,
                         grid: Sequence[Dict[str, float]]) -> Tuple:
    """The static signature a candidate's grid yields ON ITS OWN: the
    declared value-branching hypers constant across its grid, as a
    sorted ((name, value), ...) tuple. dispatch_many groups same-family
    candidates by it, so the program a candidate runs — and its float
    results — depend only on its own grid, never on its batch-mates."""
    keys = getattr(family, "static_hyper_keys", ())
    if not keys or sweep_exact() or not grid:
        return ()
    sig = []
    for k in keys:
        vals = {float(g[k]) for g in grid if k in g}
        if len(vals) == 1 and all(k in g for g in grid):
            sig.append((k, vals.pop()))
    return tuple(sorted(sig))


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


def _rows(a, sl):
    """Slice the leading (item) axis of a mask array or of an
    (idx, ok) pair."""
    if isinstance(a, tuple):
        return tuple(x[sl] for x in a)
    return a[sl]


def _n_items(a) -> int:
    return (a[0] if isinstance(a, tuple) else a).shape[0]


def _chunked_retry(run: Callable, train_b, val_b, hyper_b,
                   n_chunks: int) -> np.ndarray:
    """Sequential chunked re-dispatch of a batch -> metrics np array."""
    b = _n_items(train_b)
    step = max(1, -(-b // n_chunks))
    mets = []
    for s in range(0, b, step):
        sl = slice(s, s + step)
        mets.append(_host(run(_rows(train_b, sl), _rows(val_b, sl),
                              {k: v[sl] for k, v in hyper_b.items()})))
    return np.concatenate(mets)


def _host(metrics) -> np.ndarray:
    if isinstance(metrics, torch.Tensor):
        return metrics.cpu().numpy()
    return np.asarray(metrics)


def _put(a, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """Host array -> tensor on ``device``. To the card through pinned
    memory and a copy that does not wait: a dispatch never blocks the
    host on the device (the caching host allocator keeps the pinned
    block until its copy is done)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _pad_cols(idx: np.ndarray, ok: np.ndarray):
    """Pad gathered-row columns to a multiple of ``_row_align`` with
    zero-validity copies of row 0."""
    extra = (-idx.shape[1]) % _row_align(idx.shape[1])
    if not extra:
        return idx, ok
    return (np.pad(idx, ((0, 0), (0, extra))),
            np.pad(ok, ((0, 0), (0, extra))))


class _SweepBatch:
    """One family's (fold x combined-grid) batch. Every candidate sliced
    out of it shares the one result. It is launched at construction and
    its metrics stay where ``run`` left them until the first materialize
    brings them to the host. ``seconds`` is the host wall of the launch
    plus that of the materialize (which waits for the device). An
    out-of-memory at either re-runs the batch through ``retry(k)`` for
    k = 2, 4, 8."""

    def __init__(self, family: str, n_folds: int, grid_total: int,
                 run: Callable[[], Any], retry: Callable[[int], Any],
                 label: str, device: str):
        self.family = family
        self.n_folds = int(n_folds)
        self.grid_total = int(grid_total)
        self.label = label
        self.device = device
        self._retry_fn = retry
        self.seconds: Optional[float] = None
        self._device_metrics = None
        self._error: Optional[BaseException] = None
        self._metrics_np: Optional[np.ndarray] = None
        self._lock = threading.Lock()
        t0 = time.perf_counter()
        try:
            self._device_metrics = run()
        except Exception as e:
            if not _is_retryable_device_error(e):
                raise
            self._error = e
        self._launch_s = time.perf_counter() - t0

    def materialize(self) -> np.ndarray:
        with self._lock:
            if self._metrics_np is not None:
                return self._metrics_np
            # one arrival per device shard when the host blocks on the
            # batch (one shard: the port validates on one device)
            fault_point("models.sweep.chip_dispatch", family=self.family,
                        device=self.device, shard=0)
            t0 = time.perf_counter()
            try:
                if self._error is not None:
                    raise self._error
                metrics = _host(self._device_metrics)
            except Exception as e:
                if not _is_retryable_device_error(e):
                    raise
                metrics = self._retry(e)
            self.seconds = self._launch_s + time.perf_counter() - t0
            SWEEP_STATS.note_execute(self.label, self.seconds,
                                     metrics.shape[0])
            self._metrics_np = metrics
            self._device_metrics = None
            return metrics

    def _retry(self, first: BaseException) -> np.ndarray:
        last = first
        self._device_metrics = None
        for k in (2, 4, 8):
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            try:
                return _host(self._retry_fn(k))
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

    @staticmethod
    def from_json(doc, larger_is_better: bool) -> "ValidationResult":
        """Exact inverse of to_json for the selector's fit checkpoint:
        floats round-trip by shortest repr, so a resumed selector picks
        the same winner with the same metric values."""
        return ValidationResult(
            family=doc["family"],
            grid=[dict(g) for g in doc["grid"]],
            metric_name=doc["metric"],
            larger_is_better=bool(larger_is_better),
            grid_metrics=np.asarray(doc["gridMetrics"], dtype=np.float64),
            best_index=int(doc["bestIndex"]))


def _sweep_runner(family: ModelFamily, metric_fn, n_classes: int, repl,
                  static: Tuple, sliced: bool) -> Callable:
    """The sweep's runner: ``run(tr, va, hy, chunk)`` fits and scores
    the items in chunks of ``chunk`` (the last padded with copies of its
    first item) and returns their (b,) metrics on the device. ``tr`` /
    ``va`` are 0/1 masks (b, n), or with ``sliced`` fold_slice_batch's
    (idx, ok) pairs; ``hy`` the traced hypers (b,); ``static`` the
    constant ones, passed to the family as Python floats."""
    Xt, yt, wt = repl
    dev = Xt.device
    static_d = dict(static)
    padded: Dict[str, torch.Tensor] = {}

    def masked_data():
        if not padded:
            n = Xt.shape[0]
            extra = (-n) % _row_align(n)
            padded["X"] = torch.cat([Xt, Xt.new_zeros((extra,)
                                                      + Xt.shape[1:])])
            padded["y"] = torch.cat([yt, yt.new_zeros(extra)])
            padded["w"] = torch.cat([wt, wt.new_zeros(extra)])
        return padded["X"], padded["y"], padded["w"]

    def gather(idx, ok):
        i, o = _pad_cols(idx, ok)
        it = _put(i, dev, torch.int64)
        return Xt[it], yt[it], wt[it] * _put(o, dev)

    def run(tr, va, hy, chunk):
        b = _n_items(tr)
        mets = []
        for s in range(0, b, chunk):
            real = min(chunk, b - s)
            pick = np.arange(s, s + chunk)
            pick[real:] = s
            hyper: Dict[str, Any] = {k: _put(np.asarray(v)[pick], dev)
                                     for k, v in hy.items()}
            hyper.update(static_d)
            if sliced:
                Xc, yc, wc = gather(tr[0][pick], tr[1][pick])
                Xv, yv, wv = gather(va[0][pick], va[1][pick])
            else:
                Xp, yp, wp = masked_data()
                extra = Xp.shape[0] - tr.shape[1]
                Xc = Xp.expand((chunk,) + Xp.shape)
                yc = yv = yp.expand(chunk, -1)
                wc = wp * _put(np.pad(tr[pick], ((0, 0), (0, extra))), dev)
                wv = wp * _put(np.pad(va[pick], ((0, 0), (0, extra))), dev)
                Xv = Xc
            params = family.fit_batch(Xc, yc, wc, hyper, n_classes)
            # each item scored on its own fresh copies: a view's offset
            # in the chunk must not change how it is reduced
            for j in range(real):
                probs = family.predict_kernel(
                    tree_map(lambda v: v[j], params), Xv[j].clone(),
                    n_classes)
                mets.append(metric_fn(probs, yv[j].clone(), wv[j].clone()))
        return torch.stack(mets)

    return run


class OpValidator:
    """Shared validation loop: fit the (fold x grid) batch of one
    family — folded, or through the sweep — and aggregate per-grid-point
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
            with torch.inference_mode():
                out = family.fit_eval_grid(
                    Xt, yt, wt, _put(tr, dev), _put(va, dev),
                    {k: _put(v, dev) for k, v in hy.items()}, n_classes,
                    metric_fn)
                return out.cpu().numpy()

        return run

    @staticmethod
    def _device_data(X, y, base_w, device):
        device = torch.device(device)
        return (_put(np.asarray(X, np.float32), device),
                _put(np.asarray(y, np.float32), device),
                _put(np.asarray(base_w, np.float32), device))

    def _folded_batch(self, family, combined, train_m, val_m, repl,
                      n_classes, metric_fn) -> _SweepBatch:
        run = self._folded_runner(family, metric_fn, n_classes, repl)
        train_b, val_b, hyper_b = build_fold_grid_batch(combined, train_m,
                                                        val_m)
        label = f"folded/{family.name}/k{n_classes}"
        dev = str(repl[0].device)

        def launch(tb=train_b, vb=val_b, hb=hyper_b):
            SWEEP_STATS.note_device_dispatch(label, [dev], [_n_items(tb)])
            return run(tb, vb, hb)

        return _SweepBatch(family.name, train_m.shape[0], len(combined),
                           launch,
                           lambda k: _chunked_retry(launch, train_b, val_b,
                                                    hyper_b, k),
                           label, dev)

    def _sweep_batch(self, family, combined, train_m, val_m, repl,
                     n_classes, metric_fn, mode: str) -> _SweepBatch:
        """The sweep over one group: fused (static specialization and
        fold slicing as the knobs allow) or serial (the masked traced
        program, one candidate)."""
        n_folds = train_m.shape[0]
        G = len(combined)
        sliced = mode == "fused" and fold_sliced()
        hyper_b = stack_hyper_batch(combined, n_folds)
        if sliced:
            train_b, val_b = fold_slice_batch(train_m, val_m, G)
        else:
            train_b = np.repeat(train_m, G, axis=0)
            val_b = np.repeat(val_m, G, axis=0)
        traced, static = ((hyper_b, ()) if mode == "serial"
                          else split_static_hyper(family, hyper_b))
        label = (f"{'sweep' if mode == 'fused' else 'serial'}/{family.name}"
                 f"/{self.metric}/k{n_classes}"
                 + (f"/static{dict(static)}" if static else "")
                 + ("/sliced" if sliced else ""))
        run = _sweep_runner(family, metric_fn, n_classes, repl, static,
                            sliced)
        dev = repl[0].device
        chunk = SWEEP_CHUNK.get(dev.type, 1)

        def launch(c=chunk):
            SWEEP_STATS.note_device_dispatch(label, [str(dev)],
                                             [_n_items(train_b)])
            with torch.inference_mode():
                return run(train_b, val_b, traced, c)

        return _SweepBatch(family.name, n_folds, G, launch,
                           lambda k: launch(max(1, chunk // k)), label,
                           str(dev))

    def dispatch(self, family: ModelFamily, grid: List[Dict[str, float]],
                 X: np.ndarray, y: np.ndarray, base_w: np.ndarray,
                 n_classes: int, mesh=None, *, device=None
                 ) -> PendingValidation:
        """One candidate's (fold x grid) batch on ``device`` — the
        serial mode (TM_SWEEP_FUSION=0): the folded runner, or the
        masked traced sweep."""
        dev = _validation_device(mesh, device)
        require_ported(family)
        train_m, val_m = self._masks(len(y))
        repl = self._device_data(X, y, base_w, dev)
        metric_fn, _ = _METRIC_FNS[self.metric]
        if hasattr(family, "fit_eval_grid"):
            batch = self._folded_batch(family, grid, train_m, val_m, repl,
                                       n_classes, metric_fn)
        else:
            batch = self._sweep_batch(family, grid, train_m, val_m, repl,
                                      n_classes, metric_fn, "serial")
        return PendingValidation(family.name, grid, batch)

    def dispatch_many(self, entries: Sequence[Tuple[str, ModelFamily,
                                                    List[Dict[str, float]]]],
                      X: np.ndarray, y: np.ndarray, base_w: np.ndarray,
                      n_classes: int, mesh=None, *, device=None
                      ) -> Dict[str, PendingValidation]:
        """The fused sweep: the candidates of one family stack into ONE
        batch (folds x concatenated grids). ``entries`` is [(key,
        family, grid), ...] in candidate order; returns {key:
        PendingValidation}, each a column slice of its group's batch.
        Candidates group by (family, hyper key set, candidate_static_sig):
        ragged key sets cannot stack, and the signature keeps the
        program a candidate runs a function of its own grid. Per-item
        results do not depend on the batch (module docstring), so a
        resumed fit that re-dispatches only its unvalidated candidates
        reproduces the uninterrupted sweep."""
        dev = _validation_device(mesh, device)
        for _key, fam, _grid in entries:
            require_ported(fam)
        train_m, val_m = self._masks(len(y))
        repl = self._device_data(X, y, base_w, dev)
        metric_fn, _ = _METRIC_FNS[self.metric]

        groups: "OrderedDict[Tuple, List[int]]" = OrderedDict()
        for i, (_key, fam, grid) in enumerate(entries):
            hyper_keys = tuple(sorted(grid[0])) if grid else ()
            groups.setdefault(
                (fam.name, hyper_keys, candidate_static_sig(fam, grid)),
                []).append(i)

        out: Dict[str, PendingValidation] = {}
        for idxs in groups.values():
            fam = entries[idxs[0]][1]
            combined: List[Dict[str, float]] = []
            offsets: List[int] = []
            for i in idxs:
                offsets.append(len(combined))
                combined.extend(entries[i][2])
            if hasattr(fam, "fit_eval_grid"):
                batch = self._folded_batch(fam, combined, train_m, val_m,
                                           repl, n_classes, metric_fn)
            else:
                batch = self._sweep_batch(fam, combined, train_m, val_m,
                                          repl, n_classes, metric_fn,
                                          "fused")
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
                 n_classes: int, mesh=None, *, device=None
                 ) -> ValidationResult:
        return self.collect(self.dispatch(family, grid, X, y, base_w,
                                          n_classes, mesh, device=device))


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
