"""Raw feature filter: pre-fit QA on raw features.

Reference: core/src/main/scala/com/salesforce/op/filters/ —
`RawFeatureFilter`, `FeatureDistribution`, `FilteredRawData`,
`RawFeatureFilterResults`. Compares training vs scoring data per raw
feature: fill rates, binned value distributions, Jensen-Shannon
divergence, fill-rate deltas/ratios, and null-indicator/label
correlation; features violating the thresholds are excluded before any
stage is fit.

TPU-first note: this runs host-side on the raw columnar data (one pass,
numpy) — it gates what ever reaches the device, so there is nothing to
accelerate on-chip.

The port's copy of ``transmogrifai_tpu/filters/__init__.py`` (host code; its imports
are relative, so it is the JAX package's text).
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from ..dataset import Dataset
from ..features import types as ft
from ..features.feature import Feature
from ..stages.generator import raw_dataset_for

__all__ = ["FeatureDistribution", "RawFeatureFilter",
           "RawFeatureFilterResults"]


def _stable_bucket(s: str, n: int) -> int:
    return int.from_bytes(hashlib.md5(s.encode()).digest()[:4], "little") % n


def _cell_tokens(v: Any) -> List[str]:
    """Stringify one raw cell into hashable tokens (maps/lists expand)."""
    if v is None:
        return []
    if isinstance(v, dict):
        return [f"{k}:{x}" for k, x in v.items()]
    if isinstance(v, (list, tuple, set, frozenset)):
        return [str(x) for x in v]
    return [str(v)]


class FeatureDistribution:
    """Per-feature summary: counts, nulls, binned value distribution.

    Numerics histogram over shared edges (train's min/max reused for the
    scoring pass so bins align); everything else hashes tokens into
    `bins` buckets — FeatureDistribution.scala's two modes.
    """

    def __init__(self, name: str, count: int, nulls: int,
                 distribution: np.ndarray,
                 summary_info: Optional[Dict[str, float]] = None):
        self.name = name
        self.count = int(count)
        self.nulls = int(nulls)
        self.distribution = np.asarray(distribution, dtype=np.float64)
        self.summary_info = summary_info or {}

    @property
    def fill_rate(self) -> float:
        return 0.0 if self.count == 0 else 1.0 - self.nulls / self.count

    @staticmethod
    def compute(name: str, col: np.ndarray, wtype: Type[ft.FeatureType],
                bins: int = 100,
                edges: Optional[np.ndarray] = None) -> "FeatureDistribution":
        n = len(col)
        if issubclass(wtype, ft.OPNumeric):
            fcol = col.astype(np.float64)
            vals = fcol[~np.isnan(fcol)]
            nulls = n - len(vals)
            if edges is None:
                lo = float(vals.min()) if len(vals) else 0.0
                hi = float(vals.max()) if len(vals) else 1.0
                if hi <= lo:
                    hi = lo + 1.0
                edges = np.linspace(lo, hi, bins + 1)
            # outer +/-inf bins catch mass that drifted outside the train
            # range — without them total drift would look like "no data"
            counting_edges = np.concatenate(([-np.inf], edges, [np.inf]))
            hist, _ = np.histogram(vals, bins=counting_edges)
            return FeatureDistribution(
                name, n, nulls, hist,
                {"edges_lo": float(edges[0]), "edges_hi": float(edges[-1])})
        dist = np.zeros(bins, dtype=np.float64)
        nulls = 0
        for v in col:
            toks = _cell_tokens(v)
            if not toks:
                nulls += 1
                continue
            for t in toks:
                dist[_stable_bucket(t, bins)] += 1.0
        return FeatureDistribution(name, n, nulls, dist)

    def shared_edges(self, bins: int) -> Optional[np.ndarray]:
        if "edges_lo" not in self.summary_info:
            return None
        return np.linspace(self.summary_info["edges_lo"],
                           self.summary_info["edges_hi"], bins + 1)

    def js_divergence(self, other: "FeatureDistribution") -> float:
        """Jensen-Shannon divergence (log2, in [0, 1]) of the two binned
        distributions; 0 when either side is all-empty (nothing to
        compare). The guard is NaN-proof (`not (s > 0)` rather than
        `s == 0`): a zero-total or NaN-polluted side must yield 0.0, not
        NaN — the continuum drift monitor evaluates EMPTY windows on
        every quiet tick and a NaN score would poison the debounce."""
        p, q = self.distribution, other.distribution
        sp, sq = p.sum(), q.sum()
        if not (sp > 0) or not (sq > 0) or len(p) != len(q):
            return 0.0
        p, q = p / sp, q / sq
        m = 0.5 * (p + q)

        def kl(a, b):
            mask = a > 0
            return float(np.sum(a[mask] * np.log2(a[mask] / b[mask])))
        return 0.5 * kl(p, m) + 0.5 * kl(q, m)

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "count": self.count, "nulls": self.nulls,
                "fillRate": self.fill_rate,
                "distribution": self.distribution.tolist(),
                "summaryInfo": self.summary_info}

    @staticmethod
    def from_json(doc: Dict[str, Any]) -> "FeatureDistribution":
        """Round-trips :meth:`to_json` (``fillRate`` is derived, not
        stored). This is how the continuum monitor rehydrates a fitted
        model's train-time drift baseline out of the persisted
        ``train_summaries["rawFeatureFilter"]["trainDistributions"]``."""
        return FeatureDistribution(
            doc["name"], int(doc["count"]), int(doc["nulls"]),
            np.asarray(doc["distribution"], dtype=np.float64),
            dict(doc.get("summaryInfo") or {}))

    @staticmethod
    def empty_like(other: "FeatureDistribution") -> "FeatureDistribution":
        """A zero-count distribution shaped/edged like ``other`` — the
        seed of a streaming accumulation window that merges cleanly
        against ``other``-aligned updates."""
        return FeatureDistribution(
            other.name, 0, 0,
            np.zeros_like(other.distribution),
            dict(other.summary_info))

    def merge(self, other: "FeatureDistribution") -> "FeatureDistribution":
        """In-place streaming accumulation: add ``other``'s counts,
        nulls, and binned mass into this sketch. Refuses misaligned
        merges loudly — a different feature name, bin count, or (for
        numerics) histogram edge range would silently blend apples into
        oranges and the resulting JS divergence would be meaningless."""
        if other.name != self.name:
            raise ValueError(
                f"cannot merge distribution of {other.name!r} into "
                f"{self.name!r}")
        if len(other.distribution) != len(self.distribution):
            raise ValueError(
                f"{self.name}: cannot merge a {len(other.distribution)}-bin "
                f"distribution into a {len(self.distribution)}-bin one")
        for k in ("edges_lo", "edges_hi"):
            a, b = self.summary_info.get(k), other.summary_info.get(k)
            if a is not None and b is not None and a != b:
                raise ValueError(
                    f"{self.name}: cannot merge distributions with "
                    f"different histogram edges ({k}: {a} vs {b})")
        self.count += other.count
        self.nulls += other.nulls
        self.distribution = self.distribution + other.distribution
        return self


class RawFeatureFilterResults:
    def __init__(self):
        self.train_distributions: Dict[str, FeatureDistribution] = {}
        self.score_distributions: Dict[str, FeatureDistribution] = {}
        self.exclusion_reasons: Dict[str, List[str]] = {}

    def excluded(self) -> List[str]:
        return sorted(self.exclusion_reasons)

    def to_json(self) -> Dict[str, Any]:
        return {
            "trainDistributions": {k: d.to_json() for k, d in
                                   self.train_distributions.items()},
            "scoreDistributions": {k: d.to_json() for k, d in
                                   self.score_distributions.items()},
            "exclusionReasons": self.exclusion_reasons,
        }


class RawFeatureFilter:
    """Excludes raw predictors that are junk, drifting, or leaking.

    Defaults mirror RawFeatureFilter.scala: min_fill_rate=0.001,
    max_fill_difference=0.90, max_fill_ratio_diff=20.0,
    max_js_divergence=0.90, max_correlation=0.95, bins=100. Responses
    and `protected_features` are never dropped; JS divergence applies
    only when scoring data is provided (as in the reference, where it
    compares the train and score readers).

    The filter is ADVISORY — it only ever removes inputs — so its
    declared training failure policy is "degrade": if filter_features
    fails after the train's retry budget, Workflow.train proceeds on
    the unfiltered features and records the degradation in
    train_summaries["degraded"] instead of discarding the run
    (docs/RESILIENCE.md).
    """

    failure_policy = "degrade"

    def __init__(self, score_data=None, min_fill_rate: float = 0.001,
                 max_fill_difference: float = 0.90,
                 max_fill_ratio_diff: float = 20.0,
                 max_js_divergence: float = 0.90,
                 max_correlation: float = 0.95,
                 bins: int = 100,
                 protected_features: Sequence[str] = ()):
        self.score_data = score_data
        self.min_fill_rate = min_fill_rate
        self.max_fill_difference = max_fill_difference
        self.max_fill_ratio_diff = max_fill_ratio_diff
        self.max_js_divergence = max_js_divergence
        self.max_correlation = max_correlation
        self.bins = bins
        self.protected_features = set(protected_features)

    # Workflow hook: (raw_features, data) -> (kept_features, summary)
    def filter_features(self, raw_features: Sequence[Feature], data
                        ) -> Tuple[List[Feature], Dict[str, Any]]:
        train_ds = raw_dataset_for(data, raw_features)
        predictors = [f for f in raw_features if not f.is_response]
        score_ds = None
        if self.score_data is not None:
            score_ds = raw_dataset_for(self.score_data, predictors)

        results = RawFeatureFilterResults()
        label = self._label_column(raw_features, train_ds)

        for f in predictors:
            reasons: List[str] = []
            col = train_ds.column(f.name)
            tr = FeatureDistribution.compute(f.name, col, f.wtype, self.bins)
            results.train_distributions[f.name] = tr

            if tr.fill_rate < self.min_fill_rate:
                reasons.append(
                    f"train fill rate {tr.fill_rate:.4f} < {self.min_fill_rate}")

            if score_ds is not None and f.name in score_ds:
                sc = FeatureDistribution.compute(
                    f.name, score_ds.column(f.name), f.wtype, self.bins,
                    edges=tr.shared_edges(self.bins))
                results.score_distributions[f.name] = sc
                if sc.fill_rate < self.min_fill_rate:
                    reasons.append(f"score fill rate {sc.fill_rate:.4f} "
                                   f"< {self.min_fill_rate}")
                diff = abs(tr.fill_rate - sc.fill_rate)
                if diff > self.max_fill_difference:
                    reasons.append(f"fill rate difference {diff:.4f} "
                                   f"> {self.max_fill_difference}")
                lo = min(tr.fill_rate, sc.fill_rate)
                hi = max(tr.fill_rate, sc.fill_rate)
                ratio = float("inf") if lo == 0 and hi > 0 else (
                    1.0 if hi == 0 else hi / lo)
                if ratio > self.max_fill_ratio_diff:
                    reasons.append(f"fill rate ratio {ratio:.2f} "
                                   f"> {self.max_fill_ratio_diff}")
                js = tr.js_divergence(sc)
                if js > self.max_js_divergence:
                    reasons.append(f"JS divergence {js:.4f} "
                                   f"> {self.max_js_divergence}")

            if label is not None:
                c = self._null_label_correlation(col, f.wtype, label)
                if c is not None and abs(c) > self.max_correlation:
                    reasons.append(f"null-indicator/label correlation "
                                   f"{c:.4f} > {self.max_correlation}")

            if reasons and f.name not in self.protected_features:
                results.exclusion_reasons[f.name] = reasons

        kept = [f for f in raw_features
                if f.is_response or f.name not in results.exclusion_reasons]
        return kept, results.to_json()

    @staticmethod
    def _label_column(raw_features, ds: Dataset) -> Optional[np.ndarray]:
        for f in raw_features:
            if f.is_response and issubclass(f.wtype, ft.OPNumeric):
                y = ds.column(f.name).astype(np.float64)
                return y if np.isfinite(y).all() else None
        return None

    @staticmethod
    def _null_label_correlation(col: np.ndarray, wtype, y: np.ndarray
                                ) -> Optional[float]:
        if issubclass(wtype, ft.OPNumeric):
            isnull = np.isnan(col.astype(np.float64)).astype(np.float64)
        else:
            isnull = np.array([1.0 if not _cell_tokens(v) else 0.0
                               for v in col])
        if isnull.std() == 0 or y.std() == 0:
            return None
        return float(np.corrcoef(isnull, y)[0, 1])
