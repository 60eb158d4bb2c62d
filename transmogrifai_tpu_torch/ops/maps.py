"""Map-typed feature vectorizers: one sub-feature per observed key.

Reference: core/.../stages/impl/feature/ — RealMapVectorizer,
BinaryMapVectorizer, TextMapPivotVectorizer, MultiPickListMapVectorizer,
GeolocationMapVectorizer (one vectorizer per OPMap subtype). Keys observed
at fit time become vector slots (grouping = key in the manifest) so
insights/LOCO can attribute slots to map entries.

The port's copy of ``transmogrifai_tpu/ops/maps.py`` (host code; its imports
are relative, so it is the JAX package's text).
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Type

import numpy as np

from ..dataset import Dataset
from ..features import types as ft
from ..features.manifest import (HASH_DESCRIPTOR_PREFIX, NULL_INDICATOR,
                                 OTHER_INDICATOR,
                                 ColumnManifest, ColumnMeta)
from ..stages.base import UnaryEstimator, UnaryTransformer
from .vectorizers import (VectorizerModel, _counter_order_top,
                          _label_lookup, _use_row_loops)


def _filter_keys(keys: Sequence[str], allow: Optional[Sequence[str]],
                 deny: Optional[Sequence[str]]) -> List[str]:
    """Fit-time white/black-list key filtering — the reference's
    RichMapFeature.vectorize(whiteListKeys, blackListKeys), honored by
    every map vectorizer. `allow=None` means no whitelist; the deny
    list always wins over an allow entry."""
    out = list(keys)
    if allow is not None:
        allowed = set(allow)
        out = [k for k in out if k in allowed]
    if deny:
        denied = set(deny)
        out = [k for k in out if k not in denied]
    return out


class RealMapModel(VectorizerModel):
    in_type = ft.OPMap
    operation_name = "vecRealMap"

    def __init__(self, keys: Sequence[str] = (), fills: Sequence[float] = (),
                 track_nulls=True, uid=None, **kw):
        super().__init__(uid=uid, keys=list(keys), fills=list(fills),
                         track_nulls=track_nulls, **kw)

    def manifest(self) -> ColumnManifest:
        p, t = self.parent_name, self.parent_type
        cols = []
        for k in self.params["keys"]:
            cols.append(ColumnMeta(p, t, grouping=k, descriptor_value="value"))
            if self.params["track_nulls"]:
                cols.append(ColumnMeta(p, t, grouping=k,
                                       indicator_value=NULL_INDICATOR))
        return ColumnManifest(cols)

    def _vectorize(self, col: np.ndarray) -> np.ndarray:
        if _use_row_loops():
            return self._vectorize_rows(col)
        keys = self.params["keys"]
        fills = self.params["fills"]
        tn = self.params["track_nulls"]
        per = 2 if tn else 1
        out = np.zeros((len(col), len(keys) * per), dtype=np.float64)
        # broadcast the missing-key default once, then overwrite only
        # the entries each row actually CARRIES — per-present-entry work
        # instead of the seed loop's rows x ALL keys (a flatten-to-numpy
        # variant measured slower: tuple building + unicode conversion
        # cost more than these direct dict gets). The Binary/Date map
        # models repeat this gather shape rather than share a helper:
        # a per-entry coercion callable is exactly the overhead the
        # measurement rejected, and each class's parity test pins its
        # copy.
        if keys:
            out[:, 0::per] = np.asarray(fills, np.float64)
            if tn:
                out[:, 1::per] = 1.0
        key_pos = {k: j * per for j, k in enumerate(keys)}
        rows: List[int] = []
        bases: List[int] = []
        vals: List[Any] = []
        for r, m in enumerate(col):
            if not m:
                continue
            for k, v in m.items():
                base = key_pos.get(k)
                if base is None or v is None:
                    continue
                rows.append(r)
                bases.append(base)
                vals.append(v)
        if rows:
            # one fancy-index scatter instead of two numpy scalar writes
            # per entry (scalar __setitem__ costs more than the append)
            rows_a = np.asarray(rows, np.int64)
            bases_a = np.asarray(bases, np.int64)
            out[rows_a, bases_a] = np.asarray(vals, np.float64)
            if tn:
                out[rows_a, bases_a + 1] = 0.0
        return out

    def _vectorize_rows(self, col: np.ndarray) -> np.ndarray:
        """Seed per-row reference path (parity oracle for _vectorize)."""
        keys = self.params["keys"]
        fills = self.params["fills"]
        tn = self.params["track_nulls"]
        w = len(keys) * (2 if tn else 1)
        out = np.zeros((len(col), w), dtype=np.float64)
        for r, m in enumerate(col):
            m = m or {}
            for j, k in enumerate(keys):
                base = j * (2 if tn else 1)
                v = m.get(k)
                if v is None:
                    out[r, base] = fills[j]
                    if tn:
                        out[r, base + 1] = 1.0
                else:
                    out[r, base] = float(v)
        return out


class RealMapVectorizer(UnaryEstimator):
    in_type = ft.OPMap
    out_type = ft.OPVector
    operation_name = "vecRealMap"
    model_cls = RealMapModel

    def __init__(self, fill_with: str = "mean", track_nulls: bool = True,
                 allow_keys: Optional[List[str]] = None,
                 deny_keys: Optional[List[str]] = None, uid=None, **kw):
        super().__init__(uid=uid, fill_with=fill_with, track_nulls=track_nulls,
                         allow_keys=allow_keys, deny_keys=deny_keys, **kw)

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        # already per-present-entry (a flatten-to-np.bincount variant
        # measured 7x SLOWER: tuple building + unicode conversion cost
        # more than these dict updates)
        sums: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for m in ds.column(self.input_names[0]):
            for k, v in (m or {}).items():
                if v is None:
                    continue
                sums[k] = sums.get(k, 0.0) + float(v)
                counts[k] = counts.get(k, 0) + 1
        keys = _filter_keys(sorted(counts), self.params["allow_keys"],
                            self.params["deny_keys"])
        if self.params["fill_with"] == "mean":
            fills = [sums[k] / counts[k] if counts.get(k) else 0.0 for k in keys]
        else:
            fills = [0.0] * len(keys)
        return {"keys": keys, "fills": fills,
                "track_nulls": self.params["track_nulls"]}


class BinaryMapModel(RealMapModel):
    operation_name = "vecBinMap"

    def _vectorize(self, col: np.ndarray) -> np.ndarray:
        if _use_row_loops():
            return self._vectorize_rows(col)
        keys = self.params["keys"]
        tn = self.params["track_nulls"]
        per = 2 if tn else 1
        out = np.zeros((len(col), len(keys) * per), dtype=np.float64)
        # absent keys leave the value slot 0 (no fill semantics for
        # binary maps — the seed loop never wrote fills here)
        if keys and tn:
            out[:, 1::per] = 1.0
        key_pos = {k: j * per for j, k in enumerate(keys)}
        rows: List[int] = []
        bases: List[int] = []
        vals: List[bool] = []
        for r, m in enumerate(col):
            if not m:
                continue
            for k, v in m.items():
                base = key_pos.get(k)
                if base is None or v is None:
                    continue
                rows.append(r)
                bases.append(base)
                vals.append(bool(v))
        if rows:
            rows_a = np.asarray(rows, np.int64)
            bases_a = np.asarray(bases, np.int64)
            out[rows_a, bases_a] = np.asarray(vals, np.float64)
            if tn:
                out[rows_a, bases_a + 1] = 0.0
        return out

    def _vectorize_rows(self, col: np.ndarray) -> np.ndarray:
        """Seed per-row reference path (parity oracle for _vectorize)."""
        keys = self.params["keys"]
        tn = self.params["track_nulls"]
        w = len(keys) * (2 if tn else 1)
        out = np.zeros((len(col), w), dtype=np.float64)
        for r, m in enumerate(col):
            m = m or {}
            for j, k in enumerate(keys):
                base = j * (2 if tn else 1)
                v = m.get(k)
                if v is None:
                    if tn:
                        out[r, base + 1] = 1.0
                else:
                    out[r, base] = float(bool(v))
        return out


class BinaryMapVectorizer(UnaryEstimator):
    in_type = ft.BinaryMap
    out_type = ft.OPVector
    operation_name = "vecBinMap"
    model_cls = BinaryMapModel

    def __init__(self, track_nulls: bool = True,
                 allow_keys: Optional[List[str]] = None,
                 deny_keys: Optional[List[str]] = None, uid=None, **kw):
        super().__init__(uid=uid, track_nulls=track_nulls,
                         allow_keys=allow_keys, deny_keys=deny_keys, **kw)

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        keys = set()
        for m in ds.column(self.input_names[0]):
            keys.update((m or {}).keys())
        keys = _filter_keys(sorted(keys), self.params["allow_keys"],
                            self.params["deny_keys"])
        return {"keys": keys, "fills": [0.0] * len(keys),
                "track_nulls": self.params["track_nulls"]}


def _count_values_per_key(col) -> Dict[str, Counter]:
    """Per-map-key value counts; set-valued cells count each member."""
    per_key: Dict[str, Counter] = {}
    for m in col:
        for k, v in (m or {}).items():
            if v is None or v == "":
                continue
            vs = sorted(v) if isinstance(v, (set, frozenset)) else [v]
            for x in vs:
                per_key.setdefault(k, Counter())[str(x)] += 1
    return per_key


def _gather_values_per_key(col) -> Dict[str, List[str]]:
    """Per-map-key value lists in encounter order — the vectorized-fit
    analog of _count_values_per_key: list appends in the flatten pass,
    counting deferred to np.unique (vectorizers._counter_order_top,
    which replicates the Counter.most_common tie order exactly)."""
    per_key: Dict[str, List[str]] = {}
    for m in col:
        for k, v in (m or {}).items():
            if v is None or v == "":
                continue
            vs = sorted(v) if isinstance(v, (set, frozenset)) else [v]
            lst = per_key.get(k)
            if lst is None:
                lst = per_key[k] = []
            for x in vs:
                lst.append(str(x))
    return per_key


def _top_labels(c: Counter, top_k: int) -> List[str]:
    return sorted([v for v, _ in c.most_common(top_k)],
                  key=lambda v: (-c[v], v))


class TextMapPivotModel(VectorizerModel):
    in_type = ft.OPMap
    operation_name = "pivotMap"

    def __init__(self, key_labels: Optional[Dict[str, List[str]]] = None,
                 track_nulls=True, other_track=True, uid=None, **kw):
        super().__init__(uid=uid, key_labels=dict(key_labels or {}),
                         track_nulls=track_nulls, other_track=other_track, **kw)

    def _slots(self):
        slots = []  # (key, label|OTHER|NULL)
        for k in sorted(self.params["key_labels"]):
            for lab in self.params["key_labels"][k]:
                slots.append((k, lab))
            if self.params["other_track"]:
                slots.append((k, OTHER_INDICATOR))
            if self.params["track_nulls"]:
                slots.append((k, NULL_INDICATOR))
        return slots

    def manifest(self) -> ColumnManifest:
        p, t = self.parent_name, self.parent_type
        return ColumnManifest([ColumnMeta(p, t, grouping=k, indicator_value=lab)
                               for k, lab in self._slots()])

    def _vectorize(self, col: np.ndarray) -> np.ndarray:
        if _use_row_loops():
            return self._vectorize_rows(col)
        slots = self._slots()
        pos = {kl: i for i, kl in enumerate(slots)}
        out = np.zeros((len(col), len(slots)), dtype=np.float64)
        key_labels = self.params["key_labels"]
        keys = sorted(key_labels)
        tn = self.params["track_nulls"]
        if not keys or not len(col):
            return out
        # null indicators default ON, cleared per (row, key) with values
        # — the passes below touch only the entries rows CARRY (the seed
        # loop walked rows x all keys)
        null_cols = (np.asarray([pos[(k, NULL_INDICATOR)] for k in keys],
                                np.int64) if tn else None)
        if tn:
            out[:, null_cols] = 1.0
        return self._vectorize_entries(col, out, pos, keys, null_cols)

    def _vectorize_entries(self, col, out, pos, keys, null_cols):
        """Per-PRESENT-entry gather (sets explode to their sorted
        members), then one vectorized label lookup per key — the seed
        loop walked rows x all keys and did a per-value dict lookup."""
        key_labels = self.params["key_labels"]
        tn = self.params["track_nulls"]
        key_idx = {k: j for j, k in enumerate(keys)}
        gathered: Dict[str, Any] = {k: ([], []) for k in keys}
        for r, m in enumerate(col):
            if not m:
                continue
            for k, v in m.items():
                lst = gathered.get(k)
                if lst is None:
                    continue
                vs = (sorted(v) if isinstance(v, (set, frozenset))
                      else [] if v is None or v == "" else [v])
                if not vs:
                    continue
                rs, xs = lst
                for x in vs:
                    rs.append(r)
                    xs.append(str(x))
        for k in keys:
            rs, xs = gathered[k]
            if not rs:
                continue
            rows = np.asarray(rs, np.int64)
            strs = np.asarray(xs, dtype=str)
            # a key's gathered rows are exactly its value-carrying rows:
            # one batch clear replaces the seed's per-entry null write
            if tn:
                out[rows, null_cols[key_idx[k]]] = 0.0
            labels = key_labels[k]
            if labels:
                hit, label_i = _label_lookup(labels, strs)
                label_cols = np.asarray([pos[(k, lab)] for lab in labels],
                                        np.int64)
                out[rows[hit], label_cols[label_i[hit]]] = 1.0
            else:
                hit = np.zeros(len(rs), bool)
            if self.params["other_track"]:
                out[rows[~hit], pos[(k, OTHER_INDICATOR)]] = 1.0
        return out

    def _vectorize_rows(self, col: np.ndarray) -> np.ndarray:
        """Seed per-row reference path (parity oracle for _vectorize)."""
        slots = self._slots()
        pos = {kl: i for i, kl in enumerate(slots)}
        out = np.zeros((len(col), len(slots)), dtype=np.float64)
        for r, m in enumerate(col):
            m = m or {}
            for k in sorted(self.params["key_labels"]):
                labels = set(self.params["key_labels"][k])
                v = m.get(k)
                vs = (sorted(v) if isinstance(v, (set, frozenset))
                      else [] if v is None or v == "" else [v])
                if not vs:
                    if self.params["track_nulls"]:
                        out[r, pos[(k, NULL_INDICATOR)]] = 1.0
                    continue
                for x in vs:
                    if str(x) in labels:
                        out[r, pos[(k, str(x))]] = 1.0
                    elif self.params["other_track"]:
                        out[r, pos[(k, OTHER_INDICATOR)]] = 1.0
        return out


class TextMapPivotVectorizer(UnaryEstimator):
    in_type = ft.OPMap
    out_type = ft.OPVector
    operation_name = "pivotMap"
    model_cls = TextMapPivotModel

    def __init__(self, top_k: int = 20, track_nulls: bool = True,
                 other_track: bool = True,
                 allow_keys: Optional[List[str]] = None,
                 deny_keys: Optional[List[str]] = None, uid=None, **kw):
        super().__init__(uid=uid, top_k=top_k, track_nulls=track_nulls,
                         other_track=other_track, allow_keys=allow_keys,
                         deny_keys=deny_keys, **kw)

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        col = ds.column(self.input_names[0])
        if _use_row_loops():
            per_key = _count_values_per_key(col)
            top = lambda k: _top_labels(per_key[k], self.params["top_k"])  # noqa: E731
        else:
            per_key = _gather_values_per_key(col)
            top = lambda k: _counter_order_top(per_key[k],  # noqa: E731
                                               self.params["top_k"])
        kept = _filter_keys(sorted(per_key), self.params["allow_keys"],
                            self.params["deny_keys"])
        key_labels = {k: top(k) for k in kept}
        return {"key_labels": key_labels,
                "track_nulls": self.params["track_nulls"],
                "other_track": self.params["other_track"]}


class GeolocationMapModel(VectorizerModel):
    in_type = ft.GeolocationMap
    operation_name = "vecGeoMap"

    def __init__(self, keys: Sequence[str] = (), track_nulls=True, uid=None, **kw):
        super().__init__(uid=uid, keys=list(keys), track_nulls=track_nulls, **kw)

    def manifest(self) -> ColumnManifest:
        p, t = self.parent_name, self.parent_type
        cols = []
        for k in self.params["keys"]:
            cols.extend(ColumnMeta(p, t, grouping=k, descriptor_value=d)
                        for d in ("x", "y", "z"))
            if self.params["track_nulls"]:
                cols.append(ColumnMeta(p, t, grouping=k,
                                       indicator_value=NULL_INDICATOR))
        return ColumnManifest(cols)

    def _vectorize(self, col: np.ndarray) -> np.ndarray:
        keys = self.params["keys"]
        tn = self.params["track_nulls"]
        per = 3 + int(tn)
        out = np.zeros((len(col), len(keys) * per), dtype=np.float64)
        for r, m in enumerate(col):
            m = m or {}
            for j, k in enumerate(keys):
                xyz = ft.Geolocation(m.get(k)).to_unit_sphere() if m.get(k) else None
                if xyz is None:
                    if tn:
                        out[r, j * per + 3] = 1.0
                else:
                    out[r, j * per: j * per + 3] = xyz
        return out


class GeolocationMapVectorizer(UnaryEstimator):
    in_type = ft.GeolocationMap
    out_type = ft.OPVector
    operation_name = "vecGeoMap"
    model_cls = GeolocationMapModel

    def __init__(self, track_nulls: bool = True,
                 allow_keys: Optional[List[str]] = None,
                 deny_keys: Optional[List[str]] = None, uid=None, **kw):
        super().__init__(uid=uid, track_nulls=track_nulls,
                         allow_keys=allow_keys, deny_keys=deny_keys, **kw)

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        keys = set()
        for m in ds.column(self.input_names[0]):
            keys.update((m or {}).keys())
        return {"keys": _filter_keys(sorted(keys), self.params["allow_keys"],
                                     self.params["deny_keys"]),
                "track_nulls": self.params["track_nulls"]}


class DateMapModel(VectorizerModel):
    """DateMap -> per-key (sin, cos) on a time period + null track
    (DateMapVectorizer.scala; same convention as DateToUnitCircle)."""
    in_type = ft.DateMap
    operation_name = "vecDateMap"

    def __init__(self, keys: Sequence[str] = (),
                 time_period: str = "DayOfYear", track_nulls=True,
                 uid=None, **kw):
        super().__init__(uid=uid, keys=list(keys), time_period=time_period,
                         track_nulls=track_nulls, **kw)

    def manifest(self) -> ColumnManifest:
        p, t = self.parent_name, self.parent_type
        tp = self.params["time_period"]
        cols = []
        for k in self.params["keys"]:
            cols.append(ColumnMeta(p, t, grouping=k,
                                   descriptor_value=f"{tp}_sin"))
            cols.append(ColumnMeta(p, t, grouping=k,
                                   descriptor_value=f"{tp}_cos"))
            if self.params["track_nulls"]:
                cols.append(ColumnMeta(p, t, grouping=k,
                                       indicator_value=NULL_INDICATOR))
        return ColumnManifest(cols)

    def _vectorize(self, col: np.ndarray) -> np.ndarray:
        if _use_row_loops():
            return self._vectorize_rows(col)
        from .vectorizers import unit_circle
        keys = self.params["keys"]
        tn = self.params["track_nulls"]
        per = 2 + int(tn)
        out = np.zeros((len(col), len(keys) * per), dtype=np.float64)
        # indicator defaults ON; the entry pass gathers only PRESENT
        # keys and one batched unit_circle covers every entry (numpy's
        # f64 sin/cos are elementwise-identical scalar vs vector — the
        # parity test against _vectorize_rows pins it)
        if keys and tn:
            out[:, 2::per] = 1.0
        key_pos = {k: j * per for j, k in enumerate(keys)}
        rows: List[int] = []
        bases: List[int] = []
        vals: List[float] = []
        for r, m in enumerate(col):
            if not m:
                continue
            for k, v in m.items():
                base = key_pos.get(k)
                if base is None or v is None:
                    continue
                rows.append(r)
                bases.append(base)
                vals.append(float(v))
        if rows:
            sin, cos = unit_circle(np.asarray(vals, np.float64),
                                   self.params["time_period"])
            rows_a = np.asarray(rows, np.int64)
            bases_a = np.asarray(bases, np.int64)
            out[rows_a, bases_a] = sin
            out[rows_a, bases_a + 1] = cos
            if tn:
                out[rows_a, bases_a + 2] = 0.0
        return out

    def _vectorize_rows(self, col: np.ndarray) -> np.ndarray:
        """Seed per-row reference path (parity oracle for _vectorize)."""
        from .vectorizers import unit_circle
        keys = self.params["keys"]
        tn = self.params["track_nulls"]
        per = 2 + int(tn)
        out = np.zeros((len(col), len(keys) * per), dtype=np.float64)
        for r, m in enumerate(col):
            m = m or {}
            for j, k in enumerate(keys):
                v = m.get(k)
                if v is None:
                    if tn:
                        out[r, j * per + 2] = 1.0
                else:
                    sin, cos = unit_circle(float(v),
                                           self.params["time_period"])
                    out[r, j * per] = sin
                    out[r, j * per + 1] = cos
        return out


class DateMapVectorizer(UnaryEstimator):
    in_type = ft.DateMap
    out_type = ft.OPVector
    operation_name = "vecDateMap"
    model_cls = DateMapModel

    def __init__(self, time_period: str = "DayOfYear",
                 track_nulls: bool = True,
                 allow_keys: Optional[List[str]] = None,
                 deny_keys: Optional[List[str]] = None, uid=None, **kw):
        from .vectorizers import check_time_period
        check_time_period(time_period)
        super().__init__(uid=uid, time_period=time_period,
                         track_nulls=track_nulls, allow_keys=allow_keys,
                         deny_keys=deny_keys, **kw)

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        keys = set()
        for m in ds.column(self.input_names[0]):
            keys.update((m or {}).keys())
        return {"keys": _filter_keys(sorted(keys), self.params["allow_keys"],
                                     self.params["deny_keys"]),
                "time_period": self.params["time_period"],
                "track_nulls": self.params["track_nulls"]}


class SmartTextMapModel(VectorizerModel):
    """Per-key cardinality-adaptive text encoding: low-cardinality keys
    pivot (topK + OTHER + null), high-cardinality keys hash their tokens
    (SmartTextMapVectorizer.scala)."""
    in_type = ft.OPMap
    operation_name = "smartTextMap"

    def __init__(self, key_labels: Optional[Dict[str, List[str]]] = None,
                 hash_keys: Sequence[str] = (), num_bins: int = 64,
                 track_nulls=True, hash_seed: int = 42, uid=None, **kw):
        super().__init__(uid=uid, key_labels=dict(key_labels or {}),
                         hash_keys=list(hash_keys), num_bins=num_bins,
                         track_nulls=track_nulls, hash_seed=hash_seed, **kw)

    def _pivot(self) -> TextMapPivotModel:
        return TextMapPivotModel(key_labels=self.params["key_labels"],
                                 track_nulls=self.params["track_nulls"],
                                 other_track=True, uid=self.uid + "_pivot")

    def manifest(self) -> ColumnManifest:
        p, t = self.parent_name, self.parent_type
        pivot = self._pivot()
        pivot.inputs = self.inputs
        cols = list(pivot.manifest())
        nb = self.params["num_bins"]
        for k in self.params["hash_keys"]:
            cols.extend(ColumnMeta(p, t, grouping=k,
                                   descriptor_value=f"{HASH_DESCRIPTOR_PREFIX}{i}")
                        for i in range(nb))
            if self.params["track_nulls"]:
                cols.append(ColumnMeta(p, t, grouping=k,
                                       indicator_value=NULL_INDICATOR))
        return ColumnManifest(cols)

    def _vectorize(self, col: np.ndarray) -> np.ndarray:
        from .hashing import hash_string
        from .text import tokenize
        pivot = self._pivot()
        pivot.inputs = self.inputs
        left = pivot._vectorize(col)
        nb = self.params["num_bins"]
        tn = self.params["track_nulls"]
        seed = self.params["hash_seed"]
        per = nb + int(tn)
        hk = self.params["hash_keys"]
        right = np.zeros((len(col), len(hk) * per), dtype=np.float64)
        for r, m in enumerate(col):
            m = m or {}
            for j, k in enumerate(hk):
                v = m.get(k)
                if v is None or v == "":
                    if tn:
                        right[r, j * per + nb] = 1.0
                    continue
                for tok in tokenize(str(v)):
                    right[r, j * per + hash_string(tok, nb, seed)] += 1.0
        return np.concatenate([left, right], axis=1)


class SmartTextMapVectorizer(UnaryEstimator):
    in_type = ft.OPMap
    out_type = ft.OPVector
    operation_name = "smartTextMap"
    model_cls = SmartTextMapModel

    def __init__(self, max_cardinality: int = 30, top_k: int = 20,
                 num_bins: int = 64, track_nulls: bool = True,
                 hash_seed: int = 42,
                 allow_keys: Optional[List[str]] = None,
                 deny_keys: Optional[List[str]] = None, uid=None, **kw):
        super().__init__(uid=uid, max_cardinality=max_cardinality,
                         top_k=top_k, num_bins=num_bins,
                         track_nulls=track_nulls, hash_seed=hash_seed,
                         allow_keys=allow_keys, deny_keys=deny_keys, **kw)

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        col = ds.column(self.input_names[0])
        loops = _use_row_loops()
        per_key = (_count_values_per_key(col) if loops
                   else _gather_values_per_key(col))
        key_labels, hash_keys = {}, []
        for k in _filter_keys(sorted(per_key), self.params["allow_keys"],
                              self.params["deny_keys"]):
            c = per_key[k]
            cardinality = len(c) if loops else len(set(c))
            if cardinality <= self.params["max_cardinality"]:
                key_labels[k] = (_top_labels(c, self.params["top_k"])
                                 if loops else
                                 _counter_order_top(c, self.params["top_k"]))
            else:
                hash_keys.append(k)
        return {"key_labels": key_labels, "hash_keys": hash_keys,
                "num_bins": self.params["num_bins"],
                "track_nulls": self.params["track_nulls"],
                "hash_seed": self.params["hash_seed"]}


class FilterMapTransformer(UnaryTransformer):
    """Key filtering on the MAP itself (RichMapFeature.filter with
    whiteList/blackList keys): output keeps the input's map type, so
    downstream vectorizers/aggregations see only the allowed keys.
    `deny_keys` wins over `allow_keys` (same rule as the vectorizers'
    fit-time filtering, `_filter_keys`)."""
    in_type = ft.OPMap
    operation_name = "filterMap"

    def __init__(self, allow_keys: Optional[List[str]] = None,
                 deny_keys: Optional[List[str]] = None, uid=None, **kw):
        super().__init__(uid=uid, allow_keys=allow_keys,
                         deny_keys=deny_keys, **kw)

    def output_type(self, features):
        return features[0].wtype

    def _keep(self, k: str) -> bool:
        allow = self.params["allow_keys"]
        deny = self.params["deny_keys"]
        if allow is not None and k not in allow:
            return False
        return not (deny and k in deny)

    def transform_value(self, v):
        m = v.value
        if m is None:
            return type(v)(None)
        return type(v)({k: x for k, x in m.items() if self._keep(k)})


def default_map_vectorizer(t: Type[ft.FeatureType]):
    """Dispatch table for OPMap subtypes (None if t is not a map);
    mirrors Transmogrifier.scala's map arm."""
    if not issubclass(t, ft.OPMap):
        return None
    if issubclass(t, ft.BinaryMap):
        return BinaryMapVectorizer()
    if issubclass(t, ft.DateMap):
        return DateMapVectorizer()
    if issubclass(t, (ft.RealMap, ft.IntegralMap)):
        return RealMapVectorizer()
    if issubclass(t, ft.GeolocationMap):
        return GeolocationMapVectorizer()
    if issubclass(t, ft.MultiPickListMap):
        return TextMapPivotVectorizer()  # pivots each key's set members
    if issubclass(t, (ft.TextAreaMap,)):
        return SmartTextMapVectorizer()  # free text: cardinality-adaptive
    if issubclass(t, ft.Prediction):
        return None  # model output, not a vectorizable input
    # TextMap subtypes and untyped OPMap both pivot stringified values
    return TextMapPivotVectorizer()
