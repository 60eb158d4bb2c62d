"""Streaming drift monitor over serving traffic.

RawFeatureFilter computes per-feature binned distributions and
Jensen-Shannon divergence at TRAIN time; this module runs the same math
continuously over what the model actually serves. Each observed request
folds into per-feature streaming :class:`filters.FeatureDistribution`
sketches (numerics histogram over the BASELINE's edges so bins align;
everything else hashes tokens into the same bucket count), and each
monitor tick compares the accumulated window against the fitted model's
train-time baseline:

* the baseline comes from the artifact — the persisted
  ``train_summaries["rawFeatureFilter"]["trainDistributions"]``
  (:func:`baseline_from_model`) — or is computed directly from a
  reference dataset (:func:`baseline_from_data`) for models trained
  without the filter;
* accumulation is COMMUTATIVE (count addition), so drift scores are
  deterministic under threaded traffic: any interleaving of the same
  requests yields bitwise-identical scores;
* windows TUMBLE: once a window holds ``window_min_rows`` observed
  rows it is scored and reset, so a breach reflects recent traffic,
  not the blended history since startup;
* the trigger is DEBOUNCED: only ``debounce_windows`` CONSECUTIVE
  breaching windows fire it (one sustained breach = one trigger;
  flapping — breach, recover, breach — resets the streak and never
  storms), and empty/short windows neither breach nor reset anything;
* an empty window scores 0.0 for every feature (the js_divergence
  zero-count guard), never NaN.

Knobs ride ``DriftConfig`` with ``TM_DRIFT_*`` env spellings parsed by
the shared STRICT parser (resilience.config): a typo'd knob raises, it
can never silently disable the drift gate.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ..dataset import Dataset
from ..filters import FeatureDistribution
from ..stages.generator import raw_dataset_for

__all__ = ["DriftConfig", "DriftMonitor", "MonitorTick",
           "baseline_from_model", "baseline_from_data"]


#: TM_DRIFT_* env var -> (DriftConfig field, parser). The catalog IS the
#: validation: any other TM_DRIFT_ name is a typo and raises.
_ENV_FIELDS: Dict[str, tuple] = {
    "TM_DRIFT_THRESHOLD": ("threshold", float),
    "TM_DRIFT_DEBOUNCE_WINDOWS": ("debounce_windows", int),
    "TM_DRIFT_WINDOW_MIN_ROWS": ("window_min_rows", int),
    "TM_DRIFT_MIN_FEATURES": ("min_breach_features", int),
    "TM_DRIFT_BINS": ("bins", int),
}


class DriftConfig:
    """Drift-detection thresholds. See _ENV_FIELDS for the TM_DRIFT_*
    spellings."""

    def __init__(self, threshold: float = 0.25,
                 debounce_windows: int = 2,
                 window_min_rows: int = 256,
                 min_breach_features: int = 1,
                 bins: int = 100):
        if not (0.0 < threshold <= 1.0):
            raise ValueError("threshold must be in (0, 1] (JS divergence)")
        if debounce_windows < 1:
            raise ValueError("debounce_windows must be >= 1")
        if window_min_rows < 1:
            raise ValueError("window_min_rows must be >= 1")
        if min_breach_features < 1:
            # 0 would make EVERY complete window a breach — the trigger
            # permanently armed regardless of drift: the gate silently
            # inverted into a retrain storm
            raise ValueError("min_breach_features must be >= 1")
        if bins < 2:
            raise ValueError("bins must be >= 2")
        self.threshold = float(threshold)
        self.debounce_windows = int(debounce_windows)
        self.window_min_rows = int(window_min_rows)
        self.min_breach_features = int(min_breach_features)
        self.bins = int(bins)

    @classmethod
    def from_env(cls, environ: Optional[Dict[str, str]] = None,
                 **overrides) -> "DriftConfig":
        """TM_DRIFT_* env vars + explicit overrides (which win),
        through the shared STRICT parser: unknown name or unparsable
        value raises."""
        from ..resilience.config import parse_env_fields
        return cls(**parse_env_fields(
            "TM_DRIFT_", _ENV_FIELDS, what="drift env var",
            environ=environ, overrides=overrides))

    def as_dict(self) -> Dict[str, Any]:
        return {f: getattr(self, f) for f, _ in _ENV_FIELDS.values()}


def baseline_from_model(model) -> Optional[Dict[str, FeatureDistribution]]:
    """The fitted model's train-time per-feature distributions, out of
    the persisted RawFeatureFilter summary — the artifact IS the
    baseline, so a restarted monitor agrees with the one that watched
    the deploy. None when the model trained without the filter."""
    doc = (model.train_summaries or {}).get("rawFeatureFilter")
    if not doc or not doc.get("trainDistributions"):
        return None
    return {name: FeatureDistribution.from_json(d)
            for name, d in doc["trainDistributions"].items()}


def baseline_from_data(model, data, bins: int = 100
                       ) -> Dict[str, FeatureDistribution]:
    """Compute a baseline directly from reference data (typically the
    training set) for models whose artifact carries no filter summary."""
    predictors = [f for f in model.raw_features if not f.is_response]
    ds = raw_dataset_for(data, predictors)
    return {f.name: FeatureDistribution.compute(f.name, ds.column(f.name),
                                                f.wtype, bins)
            for f in predictors}


class MonitorTick:
    """One evaluation result: the per-feature scores as of this tick,
    which features breached, whether a window completed, and whether
    the debounced trigger fired."""

    __slots__ = ("scores", "breached", "window_complete", "triggered",
                 "window_rows")

    def __init__(self, scores: Dict[str, float], breached: List[str],
                 window_complete: bool, triggered: bool,
                 window_rows: int):
        self.scores = scores
        self.breached = breached
        self.window_complete = window_complete
        self.triggered = triggered
        self.window_rows = window_rows


class DriftMonitor:
    """See module docstring. Thread-safe: ``observe`` may be called
    from any number of threads (the accumulation is commutative), and
    ``tick``/``status`` serialize against it on one lock."""

    def __init__(self, model, *,
                 baseline: Optional[Dict[str, FeatureDistribution]] = None,
                 baseline_data=None,
                 config: Optional[DriftConfig] = None):
        self.config = config or DriftConfig.from_env()
        self._lock = threading.Lock()
        self._features: List = []       # predictor Features (name+wtype)
        self._baseline: Dict[str, FeatureDistribution] = {}
        self._gen = 0                   # bumped per set_model re-anchor
        self._window: Dict[str, FeatureDistribution] = {}
        self._window_rows = 0
        self._streak = 0                # consecutive breaching windows
        self._last_scores: Dict[str, float] = {}
        self._last_breached: List[str] = []
        self.set_model(model, baseline=baseline, baseline_data=baseline_data)

    # -- baseline management ----------------------------------------------
    def set_model(self, model, *,
                  baseline: Optional[Dict[str, FeatureDistribution]] = None,
                  baseline_data=None) -> None:
        """(Re)anchor the monitor on a fitted model — called at
        construction and again on every promotion, so drift is always
        measured against the distributions the SERVING model trained
        on. Resets the window and the debounce streak."""
        if baseline is None:
            baseline = baseline_from_model(model)
        if baseline is None and baseline_data is not None:
            baseline = baseline_from_data(model, baseline_data,
                                          bins=self.config.bins)
        if not baseline:
            raise ValueError(
                "no drift baseline: the model's train_summaries carry no "
                "rawFeatureFilter.trainDistributions (train with "
                "Workflow.with_raw_feature_filter) and no baseline/"
                "baseline_data was supplied")
        features = [f for f in model.raw_features
                    if not f.is_response and f.name in baseline]
        if not features:
            raise ValueError(
                "drift baseline names no predictor raw feature of the "
                "model — wrong model/baseline pairing?")
        with self._lock:
            self.model = model
            self._features = features
            self._baseline = dict(baseline)
            self._gen += 1      # in-flight sketches against the OLD
            #                     baseline must not merge into the new
            #                     windows (edge/bin mismatch)
            self._reset_window_locked()
            self._streak = 0
            self._last_scores = {}
            self._last_breached = []

    def _reset_window_locked(self) -> None:
        self._window = {f.name: FeatureDistribution.empty_like(
            self._baseline[f.name]) for f in self._features}
        self._window_rows = 0

    def reset(self) -> None:
        """Clear the window and the debounce streak (post-promotion /
        post-rollback hygiene — the next trigger must be earned on
        fresh traffic)."""
        with self._lock:
            self._reset_window_locked()
            self._streak = 0

    # -- observation (any thread) -----------------------------------------
    def observe(self, data) -> int:
        """Fold one request's rows into the window sketches; returns
        the row count observed. Accepts whatever the serving layer
        accepts (Dataset, column dict, row records) — the same
        raw-feature materialization path as training. Token hashing for
        non-numeric features uses the BASELINE's bin count, numerics
        the baseline's edges, so window and baseline stay comparable.

        Re-anchor safe: the feature/baseline snapshot is taken under
        the lock with a generation stamp; if ``set_model`` swapped the
        baseline while this sketch was being computed, the stale sketch
        is dropped (merging old-edge histograms into new-edge windows
        would raise) — one request lost across a promotion, by design."""
        with self._lock:
            gen = self._gen
            features = self._features
            baseline = self._baseline
        updates, n = self._sketch(features, baseline, data)
        with self._lock:
            if self._gen != gen:
                return 0
            for name, upd in updates:
                self._window[name].merge(upd)
            self._window_rows += n
        return n

    def _sketch(self, features, baseline, data
                ) -> Tuple[List[Tuple[str, FeatureDistribution]], int]:
        """Per-feature update sketches for one request — computed
        OUTSIDE the lock (the expensive part), merged under it (the
        commutative part)."""
        ds = self._as_dataset(data, features)
        updates: List[Tuple[str, FeatureDistribution]] = []
        n = 0
        for f in features:
            if f.name not in ds:
                continue
            base = baseline[f.name]
            # the BASELINE's own bin count is authoritative, never
            # config.bins: numerics carry bins+2 outer +/-inf bins, and
            # a mismatched count would trip js_divergence's length
            # guard and silently zero every numeric drift score
            if "edges_lo" in base.summary_info:
                bins = len(base.distribution) - 2
                edges = base.shared_edges(bins)
            else:
                bins, edges = len(base.distribution), None
            upd = FeatureDistribution.compute(
                f.name, ds.column(f.name), f.wtype, bins, edges=edges)
            n = max(n, upd.count)
            updates.append((f.name, upd))
        return updates, n

    def _as_dataset(self, data, features) -> Dataset:
        if isinstance(data, Dataset):
            return data
        if isinstance(data, dict):
            # {column: values} request shape (portable serving / JSONL):
            # materialize just the monitored columns through the same
            # per-type conversion training uses
            from ..dataset import column_to_numpy
            cols, schema = {}, {}
            for f in features:
                if f.name in data:
                    cols[f.name] = column_to_numpy(list(data[f.name]),
                                                   f.wtype)
                    schema[f.name] = f.wtype
            return Dataset(cols, schema)
        return raw_dataset_for(data, features)

    # -- evaluation (controller tick) -------------------------------------
    def scores(self) -> Dict[str, float]:
        with self._lock:
            return self._scores_locked()

    def _scores_locked(self) -> Dict[str, float]:
        # empty window -> 0.0 everywhere (the js_divergence zero-count
        # guard): a quiet tick is "no evidence of drift", never NaN
        return {f.name: self._baseline[f.name].js_divergence(
            self._window[f.name]) for f in self._features}

    def tick(self) -> MonitorTick:
        """Evaluate the current window. A window only completes (and
        only then can breach, advance, or reset the debounce streak)
        once it holds ``window_min_rows`` rows; completed windows
        tumble. The trigger fires when ``debounce_windows`` consecutive
        complete windows each breached — and then resets the streak, so
        one sustained breach is one trigger."""
        cfg = self.config
        with self._lock:
            window_rows = self._window_rows
            complete = window_rows >= cfg.window_min_rows
            scores = self._scores_locked()
            breached = sorted(n for n, s in scores.items()
                              if s > cfg.threshold)
            triggered = False
            if complete:
                self._last_scores = dict(scores)
                self._last_breached = list(breached)
                if len(breached) >= cfg.min_breach_features:
                    self._streak += 1
                else:
                    self._streak = 0        # flapping resets, no storms
                if self._streak >= cfg.debounce_windows:
                    triggered = True
                    self._streak = 0        # one sustained breach = one
                self._reset_window_locked()  # tumble
        return MonitorTick(scores, breached, complete, triggered,
                           window_rows)

    # -- status ------------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "config": self.config.as_dict(),
                "features": [f.name for f in self._features],
                "window_rows": self._window_rows,
                "breach_streak": self._streak,
                "last_scores": dict(self._last_scores),
                "last_breached": list(self._last_breached),
            }
