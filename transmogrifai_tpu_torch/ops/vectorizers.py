"""Per-type feature vectorizers (the port's copy of
``transmogrifai_tpu/ops/vectorizers.py``).

Reference: core/src/main/scala/com/salesforce/op/stages/impl/feature/ —
RealVectorizer (impute + null indicator), BinaryVectorizer,
OpSetVectorizer (topK one-hot + OTHER/null tracks), SmartTextVectorizer
(cardinality-adaptive pivot-vs-hash), OPCollectionHashingVectorizer,
DateToUnitCircleTransformer (sin/cos), GeolocationVectorizer,
VectorsCombiner (final concat).

Design: every vectorizer model emits an OPVector column as a dense 2D
float32 numpy block plus a ColumnManifest describing each slot's
provenance. Featurization is host-side (as in the reference, where it runs
on Spark executors' CPUs); the assembled matrix is what ships to the
card. Each model also supports the row path (`transform_value`) for local
scoring.

The device functions are torch functions on tensors that lie on one
device: :func:`impute_device_fn` (the Real and Binary vectorizers, the
portable op ``impute``) and :class:`VectorsCombiner`'s concat (``concat``).
Both are selection-only (isnan / where / stack / cat), so they match the
JAX package's device functions bitwise in f32. A fitted
:class:`RealVectorizerModel` or :class:`VectorsCombiner` is built either
by fitting (``set_input``) or from a portable artifact
(``RealVectorizerModel(fill_value=..., track_nulls=...).wire(ins, out)``).
"""
from __future__ import annotations

import math
import os
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dataset import Dataset
from ..features import types as ft
from ..features.manifest import (HASH_DESCRIPTOR_PREFIX, NULL_INDICATOR,
                                 OTHER_INDICATOR,
                                 ColumnManifest, ColumnMeta)
from ..stages.base import SequenceTransformer, UnaryEstimator, UnaryTransformer
from .hashing import hash_string
from .text import tokenize


class VectorizerModel(UnaryTransformer):
    """Base for fitted vectorizer models: column-block transform + manifest."""
    out_type = ft.OPVector

    def manifest(self) -> ColumnManifest:
        raise NotImplementedError

    def _vectorize(self, col: np.ndarray) -> np.ndarray:
        """(n,) column -> (n, k) float32 block."""
        raise NotImplementedError

    def _transform_columns(self, ds: Dataset):
        col = ds.column(self.input_names[0])
        return self._vectorize(col).astype(np.float32), ft.OPVector, self.manifest()

    def transform_value(self, v: ft.FeatureType):
        from ..dataset import column_to_numpy
        col = column_to_numpy([v.value], self.inputs[0].wtype)
        return ft.OPVector(tuple(float(x) for x in self._vectorize(col)[0]))

    @property
    def parent_name(self) -> str:
        return self.inputs[0].name

    @property
    def parent_type(self) -> str:
        return self.inputs[0].wtype.__name__


# ---------------------------------------------------------------------------
# Numerics (reference: RealVectorizer.scala, BinaryVectorizer.scala)
# ---------------------------------------------------------------------------

def impute_device_fn(fill: float, track: bool):
    """Shared device impute+indicator closure (Real & Binary vectorizers):
    the fill is rounded to f32 as the JAX package's ``jnp.where`` does."""

    def fn(col):
        col = col.to(torch.float32)
        isnull = torch.isnan(col)
        filled = torch.where(isnull, float(fill), col)
        if track:
            return torch.stack([filled, isnull.to(torch.float32)], dim=1)
        return filled[:, None]

    return fn


class RealVectorizerModel(VectorizerModel):
    in_type = ft.OPNumeric
    operation_name = "vecReal"

    def __init__(self, fill_value=0.0, track_nulls=True, uid=None, **kw):
        super().__init__(uid=uid, fill_value=fill_value,
                         track_nulls=track_nulls, **kw)

    def manifest(self) -> ColumnManifest:
        cols = [ColumnMeta(self.parent_name, self.parent_type,
                           descriptor_value="value")]
        if self.params["track_nulls"]:
            cols.append(ColumnMeta(self.parent_name, self.parent_type,
                                   indicator_value=NULL_INDICATOR))
        return ColumnManifest(cols)

    def _vectorize(self, col: np.ndarray) -> np.ndarray:
        col = col.astype(np.float64)
        isnull = np.isnan(col)
        filled = np.where(isnull, self.params["fill_value"], col)
        if self.params["track_nulls"]:
            return np.stack([filled, isnull.astype(np.float64)], axis=1)
        return filled[:, None]

    # impute+indicator is selection-only (isnan/where/stack): the f32
    # device fn matches the host f64-compute-then-cast path bitwise, so
    # the training executor may fold this stage into its fused per-layer
    # device block (executor.py)
    device_fn_exact = True

    def device_fn_signature(self):
        return ("impute", float(self.params["fill_value"]),
                bool(self.params["track_nulls"]))

    def make_device_fn(self):
        return impute_device_fn(float(self.params["fill_value"]),
                                bool(self.params["track_nulls"]))

    def portable_spec(self):
        return {"op": "impute", "fill": float(self.params["fill_value"]),
                "track": bool(self.params["track_nulls"])}


class RealVectorizer(UnaryEstimator):
    """Impute (mean/constant) + optional null-indicator track."""
    in_type = ft.OPNumeric
    out_type = ft.OPVector
    operation_name = "vecReal"
    model_cls = RealVectorizerModel

    def __init__(self, fill_with: str = "mean", fill_value: float = 0.0,
                 track_nulls: bool = True, uid=None, **kw):
        super().__init__(uid=uid, fill_with=fill_with, fill_value=fill_value,
                         track_nulls=track_nulls, **kw)

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        col = ds.column(self.input_names[0]).astype(np.float64)
        how = self.params["fill_with"]
        if how == "mean":
            fill = float(np.nanmean(col)) if not np.all(np.isnan(col)) else 0.0
        elif how == "median":
            fill = float(np.nanmedian(col)) if not np.all(np.isnan(col)) else 0.0
        elif how == "constant":
            fill = float(self.params["fill_value"])
        else:
            raise ValueError(f"unknown fill_with: {how!r}")
        return {"fill_value": fill, "track_nulls": self.params["track_nulls"]}


class BinaryVectorizer(VectorizerModel):
    """Binary -> [value, null_indicator]; no fitting required."""
    in_type = ft.Binary
    operation_name = "vecBin"

    def __init__(self, track_nulls=True, fill_value=False, uid=None, **kw):
        super().__init__(uid=uid, track_nulls=track_nulls,
                         fill_value=fill_value, **kw)

    def manifest(self) -> ColumnManifest:
        cols = [ColumnMeta(self.parent_name, self.parent_type,
                           descriptor_value="value")]
        if self.params["track_nulls"]:
            cols.append(ColumnMeta(self.parent_name, self.parent_type,
                                   indicator_value=NULL_INDICATOR))
        return ColumnManifest(cols)

    def _vectorize(self, col: np.ndarray) -> np.ndarray:
        col = col.astype(np.float64)
        isnull = np.isnan(col)
        filled = np.where(isnull, float(self.params["fill_value"]), col)
        if self.params["track_nulls"]:
            return np.stack([filled, isnull.astype(np.float64)], axis=1)
        return filled[:, None]

    device_fn_exact = True          # same selection-only argument as Real

    def device_fn_signature(self):
        return ("impute", float(self.params["fill_value"]),
                bool(self.params["track_nulls"]))

    def make_device_fn(self):
        return impute_device_fn(float(self.params["fill_value"]),
                                bool(self.params["track_nulls"]))

    def portable_spec(self):
        return {"op": "impute", "fill": float(self.params["fill_value"]),
                "track": bool(self.params["track_nulls"])}


# ---------------------------------------------------------------------------
# Categorical one-hot (reference: OpSetVectorizer.scala / OneHotEncoder)
# ---------------------------------------------------------------------------

def _text_values(col: np.ndarray) -> List[Optional[str]]:
    return [None if v is None or (isinstance(v, str) and v == "") else str(v)
            for v in col]


def _use_row_loops() -> bool:
    """TM_VECTORIZE=0 restores the seed per-row encoder loops (kept as
    the bit-exact reference implementation the vectorized paths are
    parity-tested against, and as the bench's pre-vectorization
    baseline)."""
    return os.environ.get("TM_VECTORIZE", "1") == "0"


def _counter_order_top(vals: Sequence[str], top_k: int,
                       min_support: int = 1) -> List[str]:
    """Top-k most-common values via np.unique, replicating the seed
    Counter path EXACTLY: most_common ranks by count descending with
    ties in first-seen order (CPython's stable sort over dict insertion
    order, reproduced here by lexsort on (-count, first index)), the
    min_support filter and top_k cut apply in that order, and the final
    label list re-sorts by (-count, value)."""
    if not vals:
        return []
    return _top_from_unique(
        np.unique(np.asarray(vals, dtype=str),
                  return_index=True, return_counts=True),
        top_k, min_support)


def _top_from_unique(ufc, top_k: int, min_support: int = 1) -> List[str]:
    """_counter_order_top's selection half, from an existing
    np.unique(..., return_index=True, return_counts=True) result —
    callers that also need the distinct count (SmartTextVectorizer's
    cardinality gate) run the unique pass once."""
    uniq, first, counts = ufc
    order = np.lexsort((first, -counts))
    picked = {str(uniq[i]): int(counts[i]) for i in order
              if counts[i] >= min_support}
    labels = list(picked)[:top_k]
    return sorted(labels, key=lambda v: (-picked[v], v))


def _label_lookup(labels: Sequence[str], values: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized label-index lookup: (hit mask, original label index)
    per value, via np.searchsorted over the sorted label array. The
    sort order only routes the binary search — hits map back to each
    label's ORIGINAL position, so slot layout is unchanged.

    Contract boundary (applies to every vectorized text path): numpy
    unicode arrays cannot represent trailing NUL characters, so strings
    differing only by trailing ``"\\x00"`` collapse to one value here
    while the seed row loops keep them distinct. NUL-suffixed feature
    strings are outside the parity contract (TM_VECTORIZE=0 handles
    them exactly if they ever matter)."""
    labels_arr = np.asarray(list(labels), dtype=str)
    order = np.argsort(labels_arr, kind="stable")
    sorted_labels = labels_arr[order]
    pos = np.minimum(np.searchsorted(sorted_labels, values),
                     len(labels) - 1)
    hit = sorted_labels[pos] == values
    return hit, order[pos]


class OneHotModel(VectorizerModel):
    in_type = ft.Text
    operation_name = "pivot"

    def __init__(self, labels: Sequence[str] = (), track_nulls=True,
                 other_track=True, uid=None, **kw):
        super().__init__(uid=uid, labels=list(labels), track_nulls=track_nulls,
                         other_track=other_track, **kw)

    def manifest(self) -> ColumnManifest:
        p, t = self.parent_name, self.parent_type
        cols = [ColumnMeta(p, t, grouping=p, indicator_value=v)
                for v in self.params["labels"]]
        if self.params["other_track"]:
            cols.append(ColumnMeta(p, t, grouping=p,
                                   indicator_value=OTHER_INDICATOR))
        if self.params["track_nulls"]:
            cols.append(ColumnMeta(p, t, grouping=p,
                                   indicator_value=NULL_INDICATOR))
        return ColumnManifest(cols)

    def _vectorize(self, col: np.ndarray) -> np.ndarray:
        if _use_row_loops():
            return self._vectorize_rows(col)
        labels = self.params["labels"]
        k = len(labels) + int(self.params["other_track"]) + \
            int(self.params["track_nulls"])
        out = np.zeros((len(col), k), dtype=np.float64)
        other_i = len(labels)
        null_i = len(labels) + int(self.params["other_track"])
        vals = _text_values(col)
        if not vals:
            return out
        isnull = np.fromiter((v is None for v in vals), bool, len(vals))
        # "" never collides: _text_values maps empty strings to None, so
        # no label is "" and null rows can't false-hit the lookup
        strs = np.asarray([v if v is not None else "" for v in vals],
                          dtype=str)
        if labels:
            hit, label_i = _label_lookup(labels, strs)
            hit &= ~isnull
            out[np.nonzero(hit)[0], label_i[hit]] = 1.0
        else:
            hit = np.zeros(len(vals), bool)
        if self.params["other_track"]:
            out[~isnull & ~hit, other_i] = 1.0
        if self.params["track_nulls"]:
            out[isnull, null_i] = 1.0
        return out

    def _vectorize_rows(self, col: np.ndarray) -> np.ndarray:
        """Seed per-row reference path (parity oracle for _vectorize)."""
        labels = self.params["labels"]
        index = {v: i for i, v in enumerate(labels)}
        k = len(labels) + int(self.params["other_track"]) + \
            int(self.params["track_nulls"])
        out = np.zeros((len(col), k), dtype=np.float64)
        other_i = len(labels)
        null_i = len(labels) + int(self.params["other_track"])
        for r, v in enumerate(_text_values(col)):
            if v is None:
                if self.params["track_nulls"]:
                    out[r, null_i] = 1.0
            elif v in index:
                out[r, index[v]] = 1.0
            elif self.params["other_track"]:
                out[r, other_i] = 1.0
        return out


class OneHotVectorizer(UnaryEstimator):
    """TopK one-hot with OTHER and null tracks (OpSetVectorizer analog)."""
    in_type = ft.Text
    out_type = ft.OPVector
    operation_name = "pivot"
    model_cls = OneHotModel

    def __init__(self, top_k: int = 20, min_support: int = 1,
                 track_nulls: bool = True, other_track: bool = True,
                 uid=None, **kw):
        super().__init__(uid=uid, top_k=top_k, min_support=min_support,
                         track_nulls=track_nulls, other_track=other_track, **kw)

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        col = _text_values(ds.column(self.input_names[0]))
        if _use_row_loops():
            counts = Counter(v for v in col if v is not None)
            labels = [v for v, c in counts.most_common()
                      if c >= self.params["min_support"]
                      ][: self.params["top_k"]]
            # deterministic order: by count desc then value
            labels = sorted(labels, key=lambda v: (-counts[v], v))
        else:
            labels = _counter_order_top([v for v in col if v is not None],
                                        self.params["top_k"],
                                        self.params["min_support"])
        return {"labels": labels, "track_nulls": self.params["track_nulls"],
                "other_track": self.params["other_track"]}


class MultiPickListModel(VectorizerModel):
    in_type = ft.MultiPickList
    operation_name = "multipivot"

    def __init__(self, labels: Sequence[str] = (), track_nulls=True,
                 other_track=True, uid=None, **kw):
        super().__init__(uid=uid, labels=list(labels), track_nulls=track_nulls,
                         other_track=other_track, **kw)

    manifest = OneHotModel.manifest

    def _vectorize(self, col: np.ndarray) -> np.ndarray:
        if _use_row_loops():
            return self._vectorize_rows(col)
        labels = self.params["labels"]
        k = len(labels) + int(self.params["other_track"]) + \
            int(self.params["track_nulls"])
        n = len(col)
        out = np.zeros((n, k), dtype=np.float64)
        other_i = len(labels)
        null_i = len(labels) + int(self.params["other_track"])
        if n == 0:
            return out
        lens = np.fromiter((len(vs) if vs else 0 for vs in col),
                           np.int64, n)
        if self.params["track_nulls"]:
            out[lens == 0, null_i] = 1.0
        # flatten the set members once; membership writes are idempotent
        # 1.0 assignments, so duplicate values across a set cost nothing
        flat = [str(v) for vs in col if vs for v in vs]
        if not flat:
            return out
        rows = np.repeat(np.arange(n), lens)
        strs = np.asarray(flat, dtype=str)
        if labels:
            hit, label_i = _label_lookup(labels, strs)
            out[rows[hit], label_i[hit]] = 1.0
        else:
            hit = np.zeros(len(flat), bool)
        if self.params["other_track"]:
            out[rows[~hit], other_i] = 1.0
        return out

    def _vectorize_rows(self, col: np.ndarray) -> np.ndarray:
        """Seed per-row reference path (parity oracle for _vectorize)."""
        labels = self.params["labels"]
        index = {v: i for i, v in enumerate(labels)}
        k = len(labels) + int(self.params["other_track"]) + \
            int(self.params["track_nulls"])
        out = np.zeros((len(col), k), dtype=np.float64)
        other_i = len(labels)
        null_i = len(labels) + int(self.params["other_track"])
        for r, vs in enumerate(col):
            vs = vs or frozenset()
            if not vs:
                if self.params["track_nulls"]:
                    out[r, null_i] = 1.0
                continue
            for v in vs:
                v = str(v)
                if v in index:
                    out[r, index[v]] = 1.0
                elif self.params["other_track"]:
                    out[r, other_i] = 1.0
        return out


class MultiPickListVectorizer(UnaryEstimator):
    in_type = ft.MultiPickList
    out_type = ft.OPVector
    operation_name = "multipivot"
    model_cls = MultiPickListModel

    def __init__(self, top_k: int = 20, track_nulls: bool = True,
                 other_track: bool = True, uid=None, **kw):
        super().__init__(uid=uid, top_k=top_k, track_nulls=track_nulls,
                         other_track=other_track, **kw)

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        col = ds.column(self.input_names[0])
        if _use_row_loops():
            counts: Counter = Counter()
            for vs in col:
                for v in (vs or ()):
                    counts[str(v)] += 1
            labels = [v for v, _ in counts.most_common(self.params["top_k"])]
            labels = sorted(labels, key=lambda v: (-counts[v], v))
        else:
            flat = [str(v) for vs in col if vs for v in vs]
            labels = _counter_order_top(flat, self.params["top_k"])
        return {"labels": labels, "track_nulls": self.params["track_nulls"],
                "other_track": self.params["other_track"]}


# ---------------------------------------------------------------------------
# Text hashing & smart text (reference: OPCollectionHashingVectorizer.scala,
# SmartTextVectorizer.scala)
# ---------------------------------------------------------------------------

class TextHashingVectorizer(VectorizerModel):
    """Hashing-trick token counts into a fixed number of bins."""
    in_type = ft.Text
    operation_name = "hashText"

    def __init__(self, num_bins: int = 64, binary: bool = False,
                 track_nulls: bool = True, hash_seed: int = 42, uid=None, **kw):
        super().__init__(uid=uid, num_bins=num_bins, binary=binary,
                         track_nulls=track_nulls, hash_seed=hash_seed, **kw)

    def manifest(self) -> ColumnManifest:
        p, t = self.parent_name, self.parent_type
        cols = [ColumnMeta(p, t, grouping=p, descriptor_value=f"{HASH_DESCRIPTOR_PREFIX}{i}")
                for i in range(self.params["num_bins"])]
        if self.params["track_nulls"]:
            cols.append(ColumnMeta(p, t, grouping=p,
                                   indicator_value=NULL_INDICATOR))
        return ColumnManifest(cols)

    def _vectorize(self, col: np.ndarray) -> np.ndarray:
        nb = self.params["num_bins"]
        seed = self.params["hash_seed"]
        binary = self.params["binary"]
        k = nb + int(self.params["track_nulls"])
        vals = _text_values(col)
        out = np.zeros((len(col), k), dtype=np.float64)
        rows = range(len(vals))
        # native fast path: C++ tokenizes+hashes whole ASCII cells in one
        # call (csrc/tm_hash_count_rows); flagged rows (non-ASCII / null)
        # take the exact-parity Python loop below
        try:
            from .. import native
            counts, fb = native.hash_count_rows(vals, nb, seed=seed,
                                                binary=binary)
            out[:, :nb] = counts
            rows = np.nonzero(fb)[0]
        except (RuntimeError, OSError):
            pass
        for r in rows:
            v = vals[r]
            if v is None:
                if self.params["track_nulls"]:
                    out[r, nb] = 1.0
                continue
            for tok in tokenize(v):
                b = hash_string(tok, nb, seed)
                if binary:
                    out[r, b] = 1.0
                else:
                    out[r, b] += 1.0
        return out


class SmartTextModel(VectorizerModel):
    in_type = ft.Text
    operation_name = "smartText"

    def __init__(self, mode: str = "hash", labels: Sequence[str] = (),
                 num_bins: int = 64, track_nulls=True, hash_seed: int = 42,
                 sensitive: Optional[dict] = None, uid=None, **kw):
        super().__init__(uid=uid, mode=mode, labels=list(labels),
                         num_bins=num_bins, track_nulls=track_nulls,
                         hash_seed=hash_seed,
                         sensitive=dict(sensitive or {}), **kw)
        self._delegate = self._make_delegate()

    def _make_delegate(self) -> Optional[VectorizerModel]:
        if self.params["mode"] == "removed":   # sensitive column dropped
            return None
        if self.params["mode"] == "pivot":
            d = OneHotModel(labels=self.params["labels"],
                            track_nulls=self.params["track_nulls"],
                            uid=self.uid + "_pivot")
        else:
            d = TextHashingVectorizer(num_bins=self.params["num_bins"],
                                      track_nulls=self.params["track_nulls"],
                                      hash_seed=self.params["hash_seed"],
                                      uid=self.uid + "_hash")
        return d

    def _delegate_bound(self) -> VectorizerModel:
        self._delegate.inputs = self.inputs
        self._delegate._output = self._output
        return self._delegate

    def manifest(self) -> ColumnManifest:
        if self._delegate is None:
            return ColumnManifest([])       # zero columns contributed
        return self._delegate_bound().manifest()

    def _vectorize(self, col: np.ndarray) -> np.ndarray:
        if self._delegate is None:
            return np.zeros((len(col), 0), dtype=np.float64)
        return self._delegate_bound()._vectorize(col)


class SmartTextVectorizer(UnaryEstimator):
    """Cardinality-adaptive: few distinct values -> pivot, else hashing.

    sensitive_feature_mode (reference: TransmogrifAI 0.7 sensitive
    feature detection inside SmartTextVectorizer):
      "off"          — no detection (default);
      "detect_only"  — record {pct_name, is_name} in the fitted model
                       (surfaces through params/insights), vectorize
                       normally;
      "remove"       — additionally drop a detected name column from
                       the output vector (zero columns contributed).
    Detection = ops/sensitive.py's name heuristic over the fit column.
    """
    in_type = ft.Text
    out_type = ft.OPVector
    operation_name = "smartText"
    model_cls = SmartTextModel

    def __init__(self, max_cardinality: int = 30, top_k: int = 20,
                 num_bins: int = 64, track_nulls: bool = True,
                 hash_seed: int = 42,
                 sensitive_feature_mode: str = "off",
                 name_threshold: float = 0.5, uid=None, **kw):
        if sensitive_feature_mode not in ("off", "detect_only", "remove"):
            raise ValueError(
                "sensitive_feature_mode must be off|detect_only|remove, "
                f"got {sensitive_feature_mode!r}")
        super().__init__(uid=uid, max_cardinality=max_cardinality, top_k=top_k,
                         num_bins=num_bins, track_nulls=track_nulls,
                         hash_seed=hash_seed,
                         sensitive_feature_mode=sensitive_feature_mode,
                         name_threshold=float(name_threshold), **kw)

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        col = _text_values(ds.column(self.input_names[0]))
        sensitive: Dict[str, Any] = {}
        mode_cfg = self.params["sensitive_feature_mode"]
        if mode_cfg != "off":
            from .sensitive import column_name_pct
            pct = column_name_pct(col)
            sensitive = {"pct_name": pct,
                         "is_name": pct >= self.params["name_threshold"]}
            if mode_cfg == "remove" and sensitive["is_name"]:
                return {"mode": "removed", "sensitive": sensitive,
                        "track_nulls": self.params["track_nulls"]}
        vals = [v for v in col if v is not None]
        if _use_row_loops():
            counts = Counter(vals)
            cardinality = len(counts)
        else:
            # ONE unique pass serves both the cardinality gate and the
            # top-k label selection
            ufc = (np.unique(np.asarray(vals, dtype=str),
                             return_index=True, return_counts=True)
                   if vals else (np.zeros(0, str),) * 3)
            cardinality = len(ufc[0])
        if cardinality <= self.params["max_cardinality"]:
            if _use_row_loops():
                labels = [v for v, _ in
                          counts.most_common(self.params["top_k"])]
                labels = sorted(labels, key=lambda v: (-counts[v], v))
            else:
                labels = (_top_from_unique(ufc, self.params["top_k"])
                          if vals else [])
            return {"mode": "pivot", "labels": labels,
                    "track_nulls": self.params["track_nulls"],
                    "sensitive": sensitive}
        return {"mode": "hash", "num_bins": self.params["num_bins"],
                "track_nulls": self.params["track_nulls"],
                "hash_seed": self.params["hash_seed"],
                "sensitive": sensitive}


# ---------------------------------------------------------------------------
# Dates (reference: DateToUnitCircleTransformer.scala)
# ---------------------------------------------------------------------------

_PERIODS_MS = {
    "HourOfDay": 24 * 3600_000,
    "DayOfWeek": 7 * 24 * 3600_000,
    "DayOfMonth": 30.4375 * 24 * 3600_000,
    "DayOfYear": 365.25 * 24 * 3600_000,
}


def check_time_period(name: str) -> str:
    if name not in _PERIODS_MS:
        raise ValueError(f"unknown time_period {name!r}; "
                         f"one of {sorted(_PERIODS_MS)}")
    return name


def unit_circle(values_ms: np.ndarray, time_period: str):
    """(sin, cos) phase arrays for ms timestamps on the named period —
    the ONE place the date->circle convention lives."""
    phase = 2.0 * math.pi * np.asarray(values_ms, dtype=np.float64) \
        / _PERIODS_MS[time_period]
    return np.sin(phase), np.cos(phase)


class DateToUnitCircle(VectorizerModel):
    """Date (ms epoch) -> (sin, cos) on the chosen period + null track."""
    in_type = ft.Date
    operation_name = "unitCircle"

    def __init__(self, time_period: str = "DayOfYear", track_nulls=True,
                 uid=None, **kw):
        check_time_period(time_period)
        super().__init__(uid=uid, time_period=time_period,
                         track_nulls=track_nulls, **kw)

    def manifest(self) -> ColumnManifest:
        p, t = self.parent_name, self.parent_type
        tp = self.params["time_period"]
        cols = [ColumnMeta(p, t, descriptor_value=f"{tp}_sin"),
                ColumnMeta(p, t, descriptor_value=f"{tp}_cos")]
        if self.params["track_nulls"]:
            cols.append(ColumnMeta(p, t, indicator_value=NULL_INDICATOR))
        return ColumnManifest(cols)

    def _vectorize(self, col: np.ndarray) -> np.ndarray:
        col = col.astype(np.float64)
        isnull = np.isnan(col)
        sin, cos = unit_circle(np.where(isnull, 0.0, col),
                               self.params["time_period"])
        sin = np.where(isnull, 0.0, sin)
        cos = np.where(isnull, 0.0, cos)
        if self.params["track_nulls"]:
            return np.stack([sin, cos, isnull.astype(np.float64)], axis=1)
        return np.stack([sin, cos], axis=1)


# ---------------------------------------------------------------------------
# Geolocation (reference: GeolocationVectorizer.scala)
# ---------------------------------------------------------------------------

class GeolocationModel(VectorizerModel):
    in_type = ft.Geolocation
    operation_name = "vecGeo"

    def __init__(self, fill_xyz=(0.0, 0.0, 0.0), track_nulls=True, uid=None, **kw):
        super().__init__(uid=uid, fill_xyz=list(fill_xyz),
                         track_nulls=track_nulls, **kw)

    def manifest(self) -> ColumnManifest:
        p, t = self.parent_name, self.parent_type
        cols = [ColumnMeta(p, t, descriptor_value=d) for d in ("x", "y", "z")]
        if self.params["track_nulls"]:
            cols.append(ColumnMeta(p, t, indicator_value=NULL_INDICATOR))
        return ColumnManifest(cols)

    def _vectorize(self, col: np.ndarray) -> np.ndarray:
        fill = self.params["fill_xyz"]
        k = 3 + int(self.params["track_nulls"])
        out = np.zeros((len(col), k), dtype=np.float64)
        for r, v in enumerate(col):
            g = ft.Geolocation(v if v else None)
            xyz = g.to_unit_sphere()
            if xyz is None:
                out[r, :3] = fill
                if self.params["track_nulls"]:
                    out[r, 3] = 1.0
            else:
                out[r, :3] = xyz
        return out


class GeolocationVectorizer(UnaryEstimator):
    in_type = ft.Geolocation
    out_type = ft.OPVector
    operation_name = "vecGeo"
    model_cls = GeolocationModel

    def __init__(self, fill_with: str = "mean", track_nulls: bool = True,
                 uid=None, **kw):
        super().__init__(uid=uid, fill_with=fill_with, track_nulls=track_nulls, **kw)

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        xs: List[Tuple[float, float, float]] = []
        for v in ds.column(self.input_names[0]):
            xyz = ft.Geolocation(v if v else None).to_unit_sphere()
            if xyz is not None:
                xs.append(xyz)
        if self.params["fill_with"] == "mean" and xs:
            fill = tuple(float(np.mean([x[i] for x in xs])) for i in range(3))
        else:
            fill = (0.0, 0.0, 0.0)
        return {"fill_xyz": list(fill), "track_nulls": self.params["track_nulls"]}


# ---------------------------------------------------------------------------
# Final concat (reference: VectorsCombiner.scala)
# ---------------------------------------------------------------------------

class VectorsCombiner(SequenceTransformer):
    """Concatenate OPVector features into the assembled feature matrix.

    Retains the concatenated ColumnManifest (persisted with the stage) so
    ModelInsights/LOCO can attribute slots even in workflows without a
    SanityChecker downstream."""
    in_type = ft.OPVector
    out_type = ft.OPVector
    operation_name = "combined"
    manifest: "ColumnManifest | None" = None
    transform_caches_state = True   # manifest is set BY transform; the
    # executor must not lifetime-skip it even as a terminal output

    def extra_state_json(self):
        return {"manifest": self.manifest}

    def load_extra_state(self, d):
        self.manifest = d.get("manifest")

    def _transform_columns(self, ds: Dataset):
        blocks, manifests = [], []
        for tf in self.inputs:
            arr = ds.column(tf.name)
            if arr.ndim != 2:
                raise ValueError(f"{tf.name} is not a vector column")
            # asarray, not astype: blocks are already f32, and astype's
            # unconditional copy doubled the concat's memory traffic
            blocks.append(np.asarray(arr, np.float32))
            man = ds.manifest(tf.name)
            if man is None:
                man = ColumnManifest([
                    ColumnMeta(tf.name, tf.wtype.__name__,
                               descriptor_value=f"col_{i}")
                    for i in range(arr.shape[1])])
            manifests.append(man)
        out = np.concatenate(blocks, axis=1) if blocks else np.zeros((ds.n_rows, 0), np.float32)
        self.manifest = ColumnManifest.concat(manifests)
        return out, ft.OPVector, self.manifest

    def transform_value(self, *vs: ft.OPVector):
        out: List[float] = []
        for v in vs:
            out.extend(v.value)
        return ft.OPVector(tuple(out))

    def make_device_fn(self):
        def fn(*blocks):
            return torch.cat([b.to(torch.float32) for b in blocks], dim=1)

        return fn

    def portable_spec(self):
        return {"op": "concat"}
