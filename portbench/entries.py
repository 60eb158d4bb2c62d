"""The entries a cell's window drives, one class a mix's ``entry``:
each makes its rows from the seed, fits the program once a call, and
judges a fit's outputs against the reference (``check.py``)."""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from . import check
from .generators import GENERATORS

#: the harness's span around each fit (named in a trace's idle gaps
#: where the host runs no torch operation)
FIT_SPAN = "portbench.fit"


class SelectorEntry:
    """A model selector with k-fold CV over the mix's candidate families
    (``BinaryClassificationModelSelector.with_cross_validation``) on a
    Dataset of a RealNN label and an OPVector of the configuration's
    columns, rows from the configuration's generator."""

    #: the span around each fit, which bounds a traced window
    SPAN = FIT_SPAN

    def __init__(self, config: Mapping, mix: Mapping, seed: int, device,
                 rows: Optional[int] = None):
        import torch
        from transmogrifai_tpu_torch.dataset import Dataset
        from transmogrifai_tpu_torch.features import types as ft
        self.torch = torch
        self.device = device
        self.mix = mix
        self.folds = int(mix["folds"])
        self.d = int(config["features"])
        n = int(rows or config["rows"])
        self.X, self.y = GENERATORS[config["generator"]](seed, n, self.d)
        self.ds = Dataset({"y": self.y.astype(np.float64), "x": self.X},
                          {"y": ft.RealNN, "x": ft.OPVector})
        self._sync = (torch.cuda.synchronize
                      if torch.device(device).type == "cuda"
                      else (lambda: None))

    def _selector(self):
        from transmogrifai_tpu_torch import models as TM
        from transmogrifai_tpu_torch.features import FeatureBuilder
        from transmogrifai_tpu_torch.features import types as ft
        lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
        vec = FeatureBuilder.OPVector("x").from_column().as_predictor()
        return TM.BinaryClassificationModelSelector.with_cross_validation(
            n_folds=self.folds, candidates=self.mix.get("candidates"),
            device=self.device).set_input(lbl, vec)

    def fit(self) -> Dict[str, Any]:
        """One whole fit, ending in a device synchronisation."""
        from transmogrifai_tpu_torch.models import kernels
        before = kernels.histogram_grid.launches
        sweep: Dict[str, List] = {}
        with self.sweep_fits(sweep):
            t0 = time.perf_counter()
            with self.torch.profiler.record_function(FIT_SPAN):
                model = self._selector().fit(self.ds)
                self._sync()
            wall = time.perf_counter() - t0
        walls = model.wall_seconds
        summ = model.summary
        return {"wall_s": wall,
                "families_s": dict(walls["families"]),
                "refit_s": float(walls["refit"]),
                "hist_launches": kernels.histogram_grid.launches - before,
                "summary": summ,
                "params": model.model_params, "sweep": sweep,
                "n_train": int(summ["dataCounts"]["train"]),
                "d": self.d, "folds": self.folds}

    @contextlib.contextmanager
    def sweep_fits(self, out: Dict[str, List]):
        """Each tree family's fold fits as the selector's cross-validation
        makes them (params with a leading fold x grid axis), appended to
        ``out[family]``, by wrapping the tree families' grid fit: the
        outputs the judge replays (it reads them only to judge them)."""
        from transmogrifai_tpu_torch.models import trees
        real = trees._TreeFamily._fit_grid

        def hooked(fam, *a, **k):
            params = real(fam, *a, **k)
            out.setdefault(fam.name, []).append(params)
            return params
        trees._TreeFamily._fit_grid = hooked
        try:
            yield out
        finally:
            trees._TreeFamily._fit_grid = real

    @contextlib.contextmanager
    def record_shapes(self, shapes: List):
        """Each histogram launch's (G, n, d, S, m, B, Gbins), appended to
        ``shapes``, by wrapping the tree engine's histogram entry."""
        from transmogrifai_tpu_torch.models import trees
        real = trees.histogram_grid

        def hooked(bins, stats, pos, m, B):
            G, n, S = stats.shape
            gb = bins.shape[0] if bins.dim() == 3 else 1
            shapes.append((G, n, bins.shape[-1], S, m, B, gb))
            return real(bins, stats, pos, m, B)
        trees.histogram_grid = hooked
        try:
            yield shapes
        finally:
            trees.histogram_grid = real

    def judge(self, fit: Mapping, device) -> Dict[str, float]:
        rows = check.Rows(self.X, self.y, self.folds, device)
        return check.judge(rows, fit["summary"], fit["params"],
                           fit["sweep"])

    def control(self, fit: Mapping, device) -> Dict[str, Any]:
        """The control's fit in the program's place (``check.control_fit``)."""
        rows = check.Rows(self.X, self.y, self.folds, device)
        summary, params, sweep = check.control_fit(rows, fit["summary"])
        return dict(fit, summary=summary, params=params, sweep=sweep)

    def release(self) -> None:
        """Drop the dataset the program holds (the reference reads the
        generated arrays)."""
        self.ds = None


ENTRIES = {"selector": SelectorEntry}


class SparseSelectorEntry:
    """The CTR selector (``SparseModelSelector()`` at its defaults) on a
    Dataset of a RealNN label, ``SparseIndices`` and an OPVector of
    numerics, rows from the configuration's generator; its sweep and
    refit stream the rows through ``io/stream.py``."""

    SPAN = FIT_SPAN

    def __init__(self, config: Mapping, mix: Mapping, seed: int, device,
                 rows: Optional[int] = None):
        import torch
        from transmogrifai_tpu_torch.dataset import Dataset
        from transmogrifai_tpu_torch.features import types as ft
        self.torch = torch
        self.device = device
        self.buckets = int(config["buckets"])
        n = int(rows or config["rows"])
        c = GENERATORS[config["generator"]](
            seed, n, self.buckets, **config.get("generator_args", {}))
        self.idx, self.num, self.y = c["idx"], c["num"], c["y"]
        self.ds = Dataset({"y": self.y.astype(np.float64), "sidx": self.idx,
                           "dense": self.num},
                          {"y": ft.RealNN, "sidx": ft.SparseIndices,
                           "dense": ft.OPVector})
        self._sync = (torch.cuda.synchronize
                      if torch.device(device).type == "cuda"
                      else (lambda: None))

    def _selector(self):
        from transmogrifai_tpu_torch.features import FeatureBuilder
        from transmogrifai_tpu_torch.features import types as ft
        from transmogrifai_tpu_torch.models.sparse import SparseModelSelector
        lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
        sf = FeatureBuilder.of(ft.SparseIndices, "sidx").from_column() \
            .as_predictor()
        dn = FeatureBuilder.of(ft.OPVector, "dense").from_column() \
            .as_predictor()
        return SparseModelSelector(num_buckets=self.buckets,
                                   device=self.device).set_input(lbl, sf, dn)

    def fit(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        with self.torch.profiler.record_function(FIT_SPAN):
            sel = self._selector()
            model = sel.fit(self.ds)
            self._sync()
        wall = time.perf_counter() - t0
        p = sel.params
        return {"wall_s": wall,
                "families_s": dict(model.wall_seconds["families"]),
                "refit_s": float(model.wall_seconds["refit"]),
                "hist_launches": 0, "summary": model.summary,
                "params": dict(model.model_params),
                "n_train": int(model.summary["dataCounts"]["train"]),
                "stream": {k: p[k] for k in ("n_folds", "epochs",
                                             "refit_epochs", "batch_size",
                                             "chunk_rows", "seed",
                                             "fm_dim")},
                "K": self.idx.shape[1], "d": self.num.shape[1],
                "buckets": self.buckets}

    @contextlib.contextmanager
    def record_shapes(self, shapes: List):
        yield shapes

    def judge(self, fit: Mapping, device) -> Dict[str, float]:
        return check.judge_sparse(self.idx, self.num, self.y, fit, device)

    def control(self, fit: Mapping, device) -> Dict[str, Any]:
        """The control's fit in the program's place
        (``check.control_sparse``)."""
        return check.control_sparse(self.idx, self.num, self.y, fit, device)

    def release(self) -> None:
        self.ds = None


ENTRIES["sparse_selector"] = SparseSelectorEntry
