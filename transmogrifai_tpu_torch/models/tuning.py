"""Validation & data-prep: CV / train-validation split, splitters.

Counterpart of ``transmogrifai_tpu/models/tuning.py`` (reference:
tuning/ — OpValidator, OpCrossValidation, OpTrainValidationSplit,
DataSplitter, DataBalancer, DataCutter). Folds and class balance are
sample-weight vectors, never row resampling, so every (fold x hyper)
instance of a family shares one shape and the whole grid is one batch.

Two runners validate a family's (fold x grid) batch, on one device or
sharded over a grid mesh (``parallel.get_mesh``: rank r runs a
contiguous shard of the items on its own stream, through
``parallel.grid_map``):

* the FOLDED path — a family with ``fit_eval_grid`` (the tree families)
  fits its whole batch in one call whose tree levels are one histogram
  launch each, over one quantile sketch of (X, w) shared by the batch;
* the SWEEP — any other family (the linear ones), and the tree families
  under ``TM_TREE_GRID_FOLD=0`` (the JAX package's vmapped per-instance
  path: each item bins on its own weighted sketch, and each level of a
  chunk is still one histogram launch, over per-item bins): the batch's
  items are
  fitted through the family's ``fit_batch`` with an explicit leading
  item axis, in chunks of ``SWEEP_CHUNK`` items (the last one padded
  with copies of its first item), each item on its fold's gathered rows
  (``fold_slice_batch``; ``TM_SWEEP_FOLD_SLICE=0`` or
  ``TM_SWEEP_EXACT=1``: the full rows under a 0/1 weight mask), with a
  family's declared value-branching hypers passed as Python floats
  where they are constant across the group (``split_static_hyper``),
  and each item scored by ``predict_kernel``. Nothing in it reads the
  device on the host, so the card runs it while the host dispatches
  the next family. A minibatch family may declare its own chunk for a
  batch (``sweep_chunk``, the published FT-Transformer's): its items
  then go fold-sliced in every mode, in chunks of that size, each
  chunk's fit given its items' ``base.RowPlan`` (the validator's seed,
  each item's fold, its rows' count); such a family does not shard its
  rows, so a 2-D mesh refuses it. Every other family runs as described.

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

Items are independent, so a batch's metrics are bitwise the same at
every mesh size; ``SWEEP_STATS`` credits each rank with its real items
(edge-pad copies excluded) under the mesh's labels, and the
``models.sweep.chip_dispatch`` fault point fires once per mesh rank
when the host blocks on a batch.

On a 2-D (grid x data) mesh (``parallel.get_mesh_2d``,
``TM_MESH_AXIS=grid,data``, or ``multihost.hybrid_mesh``) the items
shard over the grid rows and each row's rows over its data ranks
(``grid_map``'s 2-D branch, the ranks in lockstep through
``parallel.spmd``): the folded runner (``folded2d/...``) as it is, its
tree levels and leaf sums summed over the row's ranks; the sweep
(``sweep/.../2d``) with the full-width 0/1 mask batch, not fold-sliced,
as the JAX package runs it under 2-D (rows are sharded, so per-fold
gathers would fight the row partitioning), the linear fits' row
contractions summed over the ranks, the scores gathered before the
metric. A family whose fit does not make its row reductions through
``parallel.spmd`` (``ModelFamily.rows_sharded``) is refused there.
Every rank of every grid row is credited with the row's items;
an out-of-memory retry re-runs the batch in chunks, each booking its own
attribution. Row sums move with the sharding, so linear metrics match
the one-device ones to a tolerance, and trees bitwise where the
gradient stats are integer-valued.

Not carried over: the program caches (nothing is traced, so
``SWEEP_STATS`` records no compiles).
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
from ..parallel import spmd
from ..profiling import SWEEP_STATS
from ..resilience.faults import fault_point
from ..telemetry.spans import TRACER
from .base import ModelFamily, RowPlan, tree_map

RANDOM_SEED = 42

#: sweep modes accepted by TM_SWEEP_FUSION / resolve_sweep_mode
SWEEP_MODES = ("fused", "serial")

#: items one sweep chunk holds, by device type (see the module
#: docstring): one on the CPU, a fixed count on the card
SWEEP_CHUNK = {"cpu": 1, "cuda": 16}

#: the key of a sweep batch's per-item fold ids, beside its traced hypers
#: where the family takes a ``RowPlan`` (sharded with the items)
FOLD_KEY = "__fold__"

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


def _validation_mesh(mesh, device):
    """(the mesh a validation batch is sharded over, or None, and the
    device its replicated data goes to). ``mesh=None`` runs on the one
    device the caller names (None: CUDA, raising without a card), as
    does a mesh of one rank (on its device, on the current stream); a
    mesh of several ranks shards the batch: a 1-D mesh over its one
    axis, a ``Mesh2D`` over its grid rows and each row's data ranks."""
    if mesh is None:
        return None, resolve_device(device)
    from ..parallel.mesh import Mesh, Mesh2D
    if isinstance(mesh, Mesh2D):
        return (mesh if mesh.size > 1 else None), mesh.first_device()
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh (get_mesh) or "
                        f"Mesh2D (get_mesh_2d, hybrid_mesh), got "
                        f"{type(mesh).__name__}")
    return (mesh if mesh.size > 1 else None), mesh.devices[0]


def _is_2d(mesh) -> bool:
    """Rows sharded over a data axis (a grid x data mesh)."""
    return getattr(mesh, "is_2d_data", False)


def _require_rows_sharded(family: ModelFamily, mesh) -> None:
    """Refuse a family whose fit does not sum its row reductions over a
    data mesh (``ModelFamily.rows_sharded``): on a 2-D mesh each rank
    would fit its shard of the rows alone."""
    if _is_2d(mesh) and not family.rows_sharded:
        raise NotImplementedError(
            f"{family.name} does not make its row reductions through "
            f"parallel.spmd, so it cannot fit with its rows sharded over "
            f"a grid x data mesh; use a 1-D mesh (TM_MESH_AXIS=grid)")


def _labels(mesh, repl) -> List[str]:
    """Attribution labels of a batch's ranks: the mesh's, or the one
    device's name."""
    if mesh is None:
        return [str(repl[0].device)]
    return mesh.labels()


def _launcher(make_run: Callable, repl, labels: List[str], label: str,
              mesh) -> Callable:
    """``launch(tr, va, hy, *extra)`` for one batch: the runner
    ``make_run(repl)(tr, va, hy, *extra)`` on the one device, or over
    the mesh's ranks through ``grid_map``, each rank (each grid row's
    data ranks, in lockstep, on a 2-D mesh) running its shard with a
    runner of its own over its (X, y, w). Each call books its per-rank
    real items in ``SWEEP_STATS`` under ``labels``."""
    single = make_run(repl) if mesh is None else None

    def launch(tr, va, hy, *extra):
        from ..parallel.mesh import grid_map, mesh_rank_items
        b = _n_items(tr)
        SWEEP_STATS.note_device_dispatch(
            label, labels, [b] if mesh is None
            else mesh_rank_items(mesh, b))
        if mesh is None:
            return single(tr, va, hy, *extra)
        return grid_map(lambda shard, *rp: make_run(rp)(*shard, *extra),
                        (tr, va, hy), repl, mesh, key=label)
    return launch


def folds(family: ModelFamily) -> bool:
    """Whether ``family`` validates on the folded path: it has a folded
    fit (``fit_eval_grid``, the tree families) and ``TM_TREE_GRID_FOLD``
    is not ``0`` (which sends it through the sweep, one sketch per
    item, as the JAX package's vmapped path)."""
    return (hasattr(family, "fit_eval_grid")
            and os.environ.get("TM_TREE_GRID_FOLD", "1") != "0")


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
                 label: str, devices: Sequence[str]):
        self.family = family
        self.n_folds = int(n_folds)
        self.grid_total = int(grid_total)
        self.label = label
        #: the labels of the devices its shards ran on, in shard order
        self.devices = tuple(devices)
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
            with TRACER.region("selector.collect", family=self.family):
                # one arrival per mesh shard when the host blocks on the
                # batch, where a failed device's work surfaces; a raise
                # fails the family's whole batch, a cached collect never
                # arrives again
                for i, dev in enumerate(self.devices):
                    fault_point("models.sweep.chip_dispatch",
                                family=self.family, device=dev, shard=i)
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


def _family_chunk(family: ModelFamily, hyper_b: Dict[str, np.ndarray],
                  X: torch.Tensor) -> Optional[int]:
    """A minibatch family's own chunk for a sweep batch over rows X
    (``sweep_chunk``: its items on their folds' gathered rows, each chunk
    with a ``RowPlan``), or None: the validator's ``SWEEP_CHUNK``."""
    own = getattr(family, "sweep_chunk", None)
    return None if own is None else own(hyper_b, X)


def _sweep_runner(family: ModelFamily, metric_fn, n_classes: int, repl,
                  static: Tuple, sliced: bool,
                  plan_seed: Optional[int] = None) -> Callable:
    """The sweep's runner: ``run(tr, va, hy, chunk)`` fits and scores
    the items in chunks of ``chunk`` (the last padded with copies of its
    first item) and returns their (b,) metrics on the device. ``tr`` /
    ``va`` are 0/1 masks (b, n), or with ``sliced`` fold_slice_batch's
    (idx, ok) pairs; ``hy`` the traced hypers (b,); ``static`` the
    constant ones, passed to the family as Python floats. With
    ``plan_seed`` (sliced only) each chunk's fit is also given its items'
    ``base.RowPlan`` of that seed: their folds (``hy[FOLD_KEY]``, which
    is no hyper), their rows the folds' counts. Inside
    ``spmd.run_ranks`` (a 2-D mesh; masks only) the rows are this rank's:
    the fit sums its row contractions over the ranks, and each chunk's
    scores, labels and validation weights are gathered in origin order
    in one exchange before the metric."""
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
            with TRACER.region("sweep.chunk", family=family.name):
                mets.extend(run_chunk(tr, va, hy, s, min(chunk, b - s),
                                      chunk))
        return torch.stack(mets)

    def run_chunk(tr, va, hy, s, real, chunk):
        pick = np.arange(s, s + chunk)
        pick[real:] = s
        hyper: Dict[str, Any] = {k: _put(np.asarray(v)[pick], dev)
                                 for k, v in hy.items() if k != FOLD_KEY}
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
        kw = {}
        if plan_seed is not None:
            kw["plan"] = RowPlan(
                plan_seed, tuple(int(f) for f in hy[FOLD_KEY][pick]),
                tuple(int(r) for r in tr[1][pick].sum(axis=1)),
                chunk - real)
        params = family.fit_batch(Xc, yc, wc, hyper, n_classes, **kw)
        # each item scored on its own fresh copies: a view's offset in
        # the chunk must not change how it is reduced
        probs = [family.predict_kernel(tree_map(lambda v: v[j], params),
                                       Xv[j].clone(), n_classes)
                 for j in range(real)]
        if spmd.current() is None:
            return [metric_fn(probs[j], yv[j].clone(), wv[j].clone())
                    for j in range(real)]
        rows = tr.shape[1]              # this rank's rows, before align
        P, Y, W = spmd.gather_rows(
            (torch.stack([p[:rows] for p in probs]), 1),
            (yv[0, :rows].contiguous(), 0),
            (wv[:real, :rows].contiguous(), 1))
        return [metric_fn(P[j], Y, W[j]) for j in range(real)]

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
        the replicated (X, y, w); returns the (b,) metrics there. The
        shared quantile sketch comes from (X, w) alone, so a shard's
        trees are those of the whole batch."""
        Xt, yt, wt = repl

        def run(tr, va, hy):
            dev = Xt.device
            with torch.inference_mode():
                return family.fit_eval_grid(
                    Xt, yt, wt, _put(tr, dev), _put(va, dev),
                    {k: _put(v, dev) for k, v in hy.items()}, n_classes,
                    metric_fn)

        return run

    @staticmethod
    def _device_data(X, y, base_w, device):
        device = torch.device(device)
        return (_put(np.asarray(X, np.float32), device),
                _put(np.asarray(y, np.float32), device),
                _put(np.asarray(base_w, np.float32), device))

    def _folded_batch(self, family, combined, train_m, val_m, repl,
                      n_classes, metric_fn, mesh) -> _SweepBatch:
        _require_rows_sharded(family, mesh)
        train_b, val_b, hyper_b = build_fold_grid_batch(combined, train_m,
                                                        val_m)
        label = (f"{'folded2d' if _is_2d(mesh) else 'folded'}/"
                 f"{family.name}/k{n_classes}")
        labels = _labels(mesh, repl)
        launch = _launcher(
            lambda rp: self._folded_runner(family, metric_fn, n_classes,
                                           rp),
            repl, labels, label, mesh)
        return _SweepBatch(family.name, train_m.shape[0], len(combined),
                           lambda: launch(train_b, val_b, hyper_b),
                           lambda k: _chunked_retry(launch, train_b, val_b,
                                                    hyper_b, k),
                           label, labels)

    def _sweep_batch(self, family, combined, train_m, val_m, repl,
                     n_classes, metric_fn, mode: str, mesh) -> _SweepBatch:
        """The sweep over one group: fused (static specialization and
        fold slicing as the knobs allow) or serial (the masked traced
        program, one candidate)."""
        _require_rows_sharded(family, mesh)
        n_folds = train_m.shape[0]
        G = len(combined)
        is_2d = _is_2d(mesh)
        hyper_b = stack_hyper_batch(combined, n_folds)
        own = _family_chunk(family, hyper_b, repl[0])
        sliced = (own is not None
                  or (mode == "fused" and fold_sliced() and not is_2d))
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
                 + ("/sliced" if sliced else "") + ("/2d" if is_2d else ""))
        chunk = own or SWEEP_CHUNK.get(repl[0].device.type, 1)
        plan_seed = None
        if own is not None:
            plan_seed = self.seed
            traced = dict(traced, **{FOLD_KEY: np.repeat(np.arange(n_folds),
                                                         G)})
        labels = _labels(mesh, repl)
        launch = _launcher(
            lambda rp: _sweep_runner(family, metric_fn, n_classes, rp,
                                     static, sliced, plan_seed),
            repl, labels, label, mesh)

        def run(c=chunk):
            with torch.inference_mode():
                return launch(train_b, val_b, traced, c)

        def retry(k):
            if not is_2d:
                return run(max(1, chunk // k))
            # the JAX package's 2-D retry: the batch in k sequential
            # chunks, each booking its own attribution
            with torch.inference_mode():
                return _chunked_retry(
                    lambda t, v, h: launch(t, v, h, chunk),
                    train_b, val_b, traced, k)

        return _SweepBatch(family.name, n_folds, G, run, retry, label,
                           labels)

    def dispatch(self, family: ModelFamily, grid: List[Dict[str, float]],
                 X: np.ndarray, y: np.ndarray, base_w: np.ndarray,
                 n_classes: int, mesh=None, *, device=None
                 ) -> PendingValidation:
        """One candidate's (fold x grid) batch on ``device``, or sharded
        over the grid ``mesh`` — the serial mode (TM_SWEEP_FUSION=0):
        the folded runner, or the masked traced sweep."""
        mesh, dev = _validation_mesh(mesh, device)
        train_m, val_m, repl = self._stage(X, y, base_w, dev)
        metric_fn, _ = _METRIC_FNS[self.metric]
        with TRACER.region("selector.dispatch", family=family.name,
                           items=train_m.shape[0] * len(grid)):
            if folds(family):
                batch = self._folded_batch(family, grid, train_m, val_m,
                                           repl, n_classes, metric_fn, mesh)
            else:
                batch = self._sweep_batch(family, grid, train_m, val_m, repl,
                                          n_classes, metric_fn, "serial",
                                          mesh)
        return PendingValidation(family.name, grid, batch)

    def _stage(self, X, y, base_w, dev):
        """The fold masks and the training rows on the card."""
        with TRACER.region("selector.stage"):
            train_m, val_m = self._masks(len(y))
            return train_m, val_m, self._device_data(X, y, base_w, dev)

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
        reproduces the uninterrupted sweep, on a mesh of any size."""
        mesh, dev = _validation_mesh(mesh, device)
        train_m, val_m, repl = self._stage(X, y, base_w, dev)
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
            with TRACER.region("selector.dispatch", family=fam.name,
                               items=train_m.shape[0] * len(combined)):
                if folds(fam):
                    batch = self._folded_batch(fam, combined, train_m,
                                               val_m, repl, n_classes,
                                               metric_fn, mesh)
                else:
                    batch = self._sweep_batch(fam, combined, train_m,
                                              val_m, repl, n_classes,
                                              metric_fn, "fused", mesh)
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
