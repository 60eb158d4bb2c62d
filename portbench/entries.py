"""The entries a cell's window drives, one class a mix's ``entry``:
each makes its rows from the seed, fits the program once a call, and
judges a fit's outputs against the reference (``check.py``).

:func:`resolve` finds the class a mix names: one of ``ENTRIES`` here, or
else the ``ENTRY`` attribute of ``portbench/entry_<name>.py``, so that a
new configuration brings its entry as a file of its own. ``run.load_cell``
resolves it once, as ``cell["entry"]``, from which ``run.run_cell`` and
``control.readings`` build it.

What the harness asks of an entry class (``run.run_cell``,
``run.window``, ``control.readings``):

* ``__init__(config, mix, seed, device, rows=None)`` -- the rows from the
  seed, made once, untimed (``rows`` cuts the configuration's count for a
  rehearsal on the CPU);
* ``SPAN`` -- the host span each fit opens (``record_function``); a
  traced window runs from the first such span to the end of the last;
* ``fit()`` -- one whole fit, ending in a device synchronisation, as a
  dict (below);
* ``record_shapes(shapes)`` -- a context manager around the traced window
  that appends each histogram launch's shape to ``shapes``
  (``hist_roofline``); an entry that launches none yields it untouched;
* ``judge(fit, device)`` -- the fit's compared numbers by name, each held
  against the plain reference; ``check.verdict`` holds them to the cell's
  ``limits/<cell>.json``, which must name every one;
* ``control(fit, device)`` -- the fit with the control's outputs in the
  program's place, for ``judge`` to read (``control.py`` alone);
* ``release()`` -- drops what the program holds before the judge runs.

The keys of ``fit()``'s dict that the shared readers and ``run_cell``
read, with the readers that need each:

* ``wall_s`` -- the fit's host-clock seconds: ``rest_s``, ``fit_mfu``,
  ``ctr_fit_mfu``;
* ``families_s`` -- each family's sweep seconds: ``sweep_s``,
  ``ctr_sweep_s``, ``rest_s``;
* ``refit_s`` -- the winner's refit seconds: no reader yet;
* ``hist_launches`` -- histogram launches in the fit: ``hist_launches``;
* ``summary`` -- the fitted selector's summary, its
  ``validationResults`` and ``bestModel``: ``fit_mfu``, ``ctr_fit_mfu``,
  ``ctr_step_ms``, and ``control.readings`` (the winner's family);
* ``params``, ``sweep`` -- the outputs the entry's own ``judge`` reads;
  ``run_cell`` sets both to None in every fit it does not judge;
* ``n_train`` -- the training rows: ``fit_mfu``, ``ctr_fit_mfu``,
  ``ctr_step_ms``;
* ``d`` -- the feature width: ``fit_mfu``, ``ctr_fit_mfu``;
* ``folds`` -- the CV folds: ``fit_mfu``.

The CTR readers also read ``stream``, ``K`` and ``buckets``
(``SparseSelectorEntry``). The end-to-end time of a fit is not
``wall_s`` but the window's seconds over its fits, reported under the
mix's ``fit_metric`` (``fit_s``, ``ctr_fit_s``): of a mix, the harness
reads ``entry`` and ``fit_metric``, and the rest is the entry's.

A new entry may subclass ``SelectorEntry`` and override ``judge``,
``control`` and ``sweep_fits``. It may use ``check.Rows``,
``check.verdict`` and ``reference/*`` as they are; a reference of its
own goes in ``portbench/reference/<name>.py``. Its cell brings
``portbench/tests/rehearsal/<cell>.json`` (``test_portbench_rehearsal.py``).
"""
from __future__ import annotations

import contextlib
import importlib
import re
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


#: an entry's name, and so the suffix of its module ``entry_<name>``
ENTRY_NAME = re.compile(r"[a-z][a-z0-9_]{0,31}")


def resolve(name: str) -> type:
    """The entry class a mix names: ``ENTRIES[name]``, or else the
    ``ENTRY`` attribute of the module ``portbench/entry_<name>.py``.
    Raises SystemExit, naming the file it looked for, for a name outside
    ``ENTRY_NAME``, a module that does not exist or one without
    ``ENTRY``."""
    path = f"portbench/entry_{name}.py"
    if not isinstance(name, str) or not ENTRY_NAME.fullmatch(name):
        raise SystemExit(f"entry name {name!r} does not match "
                         f"^{ENTRY_NAME.pattern}$: no {path} is looked for")
    if name in ENTRIES:
        return ENTRIES[name]
    module = "portbench.entry_" + name
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise SystemExit(f"unknown entry {name!r}: not one of "
                         f"{sorted(ENTRIES)}, and no {path}") from None
    cls = getattr(mod, "ENTRY", None)
    if not isinstance(cls, type):
        raise SystemExit(f"entry {name!r}: {path} defines no ENTRY class")
    return cls
