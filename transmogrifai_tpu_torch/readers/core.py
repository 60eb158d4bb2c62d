"""Reader implementations (see package docstring for reference
mapping; the port's copy of ``transmogrifai_tpu/readers/core.py``)."""
from __future__ import annotations

import csv
import re
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple, Type)

import numpy as np

from ..dataset import Dataset, column_to_numpy
from ..features import aggregators as agg
from ..features import types as ft
from ..features.feature import Feature


def _key_fn(key) -> Callable[[Mapping[str, Any]], Any]:
    if key is None:
        return lambda r: None
    if callable(key):
        return key
    return lambda r, k=key: r.get(k)


class DataReader:
    """Simple reader over in-memory records (dicts or objects).

    Reference: readers/DataReader.scala. `read()` yields raw records;
    `generate_dataset(features)` applies raw-feature extract fns
    (reader.generateDataFrame).
    """

    def __init__(self, records: Optional[Iterable[Any]] = None, key=None):
        self._records = list(records) if records is not None else []
        self.key_fn = _key_fn(key)

    def read(self) -> List[Any]:
        return list(self._records)

    def generate_dataset(self, features: Sequence[Feature]) -> Dataset:
        from ..stages.generator import materialize_raw
        return materialize_raw(self.read(), features)


# ---------------------------------------------------------------------------
# CSV (reference: CSVProductReader / CSVAutoReader / CSVReaders.scala)
# ---------------------------------------------------------------------------

_TRUE = {"true", "t", "yes", "y", "1"}
_FALSE = {"false", "f", "no", "n", "0"}
_NULLS = {"", "null", "na", "n/a", "none", "nan"}
_EMAIL_RE = re.compile(r"^[^@\s]+@[^@\s]+\.[^@\s]+$")


def _parse_cell(s: Optional[str], wtype: Type[ft.FeatureType]) -> Any:
    if s is None or s.strip().lower() in _NULLS:
        return None
    s = s.strip()
    if issubclass(wtype, ft.Binary):
        low = s.lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ValueError(f"cannot parse {s!r} as Binary")
    if issubclass(wtype, ft.Integral):
        return int(float(s))
    if issubclass(wtype, ft.OPNumeric):
        return float(s)
    if issubclass(wtype, (ft.OPList, ft.OPSet)):
        items = [x.strip() for x in s.split("|") if x.strip() != ""]
        if issubclass(wtype, ft.DateList):
            return [int(float(x)) for x in items]
        if issubclass(wtype, ft.Geolocation):
            return [float(x) for x in items]
        return items
    return s


class CSVProductReader(DataReader):
    """CSV -> typed record dicts under a declared schema.

    Cells are parsed per feature type; `|` separates collection items.
    """

    def __init__(self, path: str, schema: Mapping[str, Type[ft.FeatureType]],
                 key=None, header: bool = True, delimiter: str = ","):
        super().__init__(records=None, key=key)
        self.path = path
        self.schema = dict(schema)
        self.header = header
        self.delimiter = delimiter

    def generate_dataset(self, features) -> "Dataset":
        fast = self._native_dataset(features)
        if fast is not None:
            return fast
        return super().generate_dataset(features)

    def _native_dataset(self, features) -> "Optional[Dataset]":
        """Columnar fast path through csrc/libtmnative.so: numeric columns
        parse C-side straight into float64 blocks (no per-cell Python
        objects). Applies only when every feature is a plain same-named
        column lookup with no aggregator; semantics match the row path."""
        from ..stages.generator import FeatureGeneratorStage
        from .. import native
        if not self.header or len(self.delimiter) != 1:
            return None
        plan = []
        for f in features:
            st = f.origin_stage
            if not (isinstance(st, FeatureGeneratorStage)
                    and st.aggregator is None
                    and getattr(st.extract_fn, "column_name", None) == f.name
                    and f.name in self.schema):
                return None
            plan.append(f)
        # Binary/collection cells need token parsing; only plain numerics
        # take the C float path
        numeric = [f.name for f in plan
                   if issubclass(f.wtype, ft.OPNumeric)
                   and not issubclass(f.wtype, ft.Binary)]
        if not native.available():
            return None
        try:
            header, cols = native.load_csv_columns(self.path, self.delimiter,
                                                   numeric_cols=numeric)
        except (RuntimeError, ValueError, IOError):
            return None  # odd cells / missing lib: row path decides
        if any(h not in self.schema for h in header):
            return None  # schema mismatch: row path raises its usual error
        out_cols: Dict[str, np.ndarray] = {}
        schema: Dict[str, Any] = {}
        for f in plan:
            raw = cols.get(f.name)
            if raw is None:
                return None
            if isinstance(raw, np.ndarray):
                if issubclass(f.wtype, ft.Integral):
                    # row-path parity: int(float(s)) truncates toward zero
                    raw = np.trunc(raw)
                out_cols[f.name] = raw
            else:
                vals = []
                for i, s in enumerate(raw):
                    try:
                        vals.append(_parse_cell(s, self.schema[f.name]))
                    except ValueError as e:
                        raise ValueError(f"{self.path} row {i + 1} column "
                                         f"{f.name!r}: {e}") from e
                out_cols[f.name] = column_to_numpy(vals, f.wtype)
            schema[f.name] = f.wtype
        return Dataset(out_cols, schema)

    def read(self) -> List[Dict[str, Any]]:
        names = list(self.schema)
        out: List[Dict[str, Any]] = []
        with open(self.path, newline="") as fh:
            rows = csv.reader(fh, delimiter=self.delimiter)
            for i, row in enumerate(rows):
                if i == 0 and self.header:
                    names = [n.strip() for n in row]
                    unknown = [n for n in names if n not in self.schema]
                    if unknown:
                        raise ValueError(f"CSV columns not in schema: {unknown}")
                    continue
                rec: Dict[str, Any] = {}
                for name, cell in zip(names, row):
                    try:
                        rec[name] = _parse_cell(cell, self.schema[name])
                    except ValueError as e:
                        raise ValueError(
                            f"{self.path} row {i} column {name!r}: {e}") from e
                out.append(rec)
        return out


def infer_csv_schema(path: str, delimiter: str = ",", sample_rows: int = 1000,
                     picklist_max_card: int = 50
                     ) -> Dict[str, Type[ft.FeatureType]]:
    """Infer a FeatureType per CSV column from sampled values.

    Reference: CSVAutoReader's Avro schema inference — here typed directly:
    all-int -> Integral, numeric -> Real, boolean tokens -> Binary, email
    pattern -> Email, low-cardinality strings -> PickList, else Text.
    """
    with open(path, newline="") as fh:
        rows = csv.reader(fh, delimiter=delimiter)
        header = next(rows)
        names = [n.strip() for n in header]
        samples: List[List[str]] = [[] for _ in names]
        for i, row in enumerate(rows):
            if i >= sample_rows:
                break
            for j, cell in enumerate(row[:len(names)]):
                samples[j].append(cell)

    schema: Dict[str, Type[ft.FeatureType]] = {}
    for name, vals in zip(names, samples):
        present = [v.strip() for v in vals
                   if v is not None and v.strip().lower() not in _NULLS]
        schema[name] = _infer_column_type(present, picklist_max_card)
    return schema


def _infer_column_type(vals: List[str], picklist_max_card: int
                       ) -> Type[ft.FeatureType]:
    if not vals:
        return ft.Text
    low = {v.lower() for v in vals}
    if low <= (_TRUE | _FALSE) and low & _TRUE and low & _FALSE:
        return ft.Binary

    def _all(pred):
        try:
            return all(pred(v) for v in vals)
        except (ValueError, OverflowError):
            return False
    if _all(lambda v: float(v) == int(float(v))):
        return ft.Integral
    def _is_float(v):
        float(v)
        return True
    if _all(_is_float):
        return ft.Real
    if all(_EMAIL_RE.match(v) for v in vals):
        return ft.Email
    if len(set(vals)) <= picklist_max_card:
        return ft.PickList
    return ft.Text


class CSVAutoReader(CSVProductReader):
    """CSV reader with automatic schema inference."""

    def __init__(self, path: str, key=None, delimiter: str = ",",
                 response: Optional[str] = None,
                 overrides: Optional[Mapping[str, Type[ft.FeatureType]]] = None):
        schema = infer_csv_schema(path, delimiter=delimiter)
        schema.update(overrides or {})
        if response is not None:
            schema[response] = ft.RealNN
        super().__init__(path, schema, key=key, delimiter=delimiter)


# ---------------------------------------------------------------------------
# Aggregate / Conditional (reference: AggregateDataReader.scala,
# ConditionalDataReader.scala)
# ---------------------------------------------------------------------------

def _time_fn(time) -> Callable[[Mapping[str, Any]], Optional[float]]:
    if callable(time):
        return time
    return lambda r, k=time: (None if r.get(k) is None else float(r.get(k)))


def _aggregate_groups(groups: "Dict[Any, List[Tuple[float, Any]]]",
                      features: Sequence[Feature],
                      cutoff: agg.CutOffTime,
                      response_window: Optional[float] = None) -> Dataset:
    """One output row per key: predictors fold events before the key's
    cutoff, responses fold events at/after it (within response_window)."""
    from ..stages.generator import FeatureGeneratorStage
    keys = sorted(groups, key=repr)
    cols: Dict[str, List[Any]] = {f.name: [] for f in features}
    plan = []
    for f in features:
        stage = f.origin_stage
        if not isinstance(stage, FeatureGeneratorStage):
            raise ValueError(f"{f.name} is not a raw feature")
        plan.append((f, stage, agg.resolve(stage.aggregator, f.wtype)))
    for k in keys:
        events = sorted(groups[k], key=lambda te: te[0])
        cut = cutoff.for_key(k)
        if cut is None:
            pre = post = [e for _, e in events]
        else:
            pre = [e for t, e in events if t < cut]
            post = [e for t, e in events
                    if t >= cut and (response_window is None
                                     or t < cut + response_window)]
        for f, stage, monoid in plan:
            src = post if f.is_response else pre
            cols[f.name].append(monoid([stage.extract(r) for r in src]))
    ds_cols = {f.name: column_to_numpy(cols[f.name], f.wtype) for f in features}
    schema = {f.name: f.wtype for f in features}
    key_name = "key"
    if key_name not in schema:
        ds_cols[key_name] = np.array([str(k) for k in keys], dtype=object)
        schema[key_name] = ft.ID
    return Dataset(ds_cols, schema)


class AggregateDataReader(DataReader):
    """Event records -> one row per key via per-feature monoid aggregation.

    `time` names a timestamp field (or is a record->ts fn); `cutoff`
    splits predictor history from the response window.
    """

    def __init__(self, base: Any, key, time, cutoff: Optional[agg.CutOffTime] = None):
        super().__init__(records=None, key=key)
        self.base = base if isinstance(base, DataReader) else DataReader(base)
        self.time_fn = _time_fn(time)
        self.cutoff = cutoff or agg.CutOffTime.no_cutoff()

    def read(self) -> List[Any]:
        return self.base.read()

    def generate_dataset(self, features: Sequence[Feature]) -> Dataset:
        groups: Dict[Any, List[Tuple[float, Any]]] = {}
        for r in self.read():
            k = self.key_fn(r)
            t = self.time_fn(r)
            groups.setdefault(k, []).append((t if t is not None else 0.0, r))
        return _aggregate_groups(groups, features, self.cutoff)


class ConditionalDataReader(AggregateDataReader):
    """Aggregate reader whose cutoff is each key's first event matching a
    target condition; keys with no match are dropped (responseOnly keeps
    them with empty responses).
    """

    def __init__(self, base: Any, key, time,
                 target_condition: Callable[[Any], bool],
                 response_window: Optional[float] = None,
                 drop_if_no_target: bool = True):
        super().__init__(base, key, time, cutoff=None)
        self.target_condition = target_condition
        self.response_window = response_window
        self.drop_if_no_target = drop_if_no_target

    def generate_dataset(self, features: Sequence[Feature]) -> Dataset:
        groups: Dict[Any, List[Tuple[float, Any]]] = {}
        for r in self.read():
            k = self.key_fn(r)
            t = self.time_fn(r)
            groups.setdefault(k, []).append((t if t is not None else 0.0, r))

        targets: Dict[Any, Optional[float]] = {}
        for k, events in groups.items():
            ts = [t for t, e in sorted(events, key=lambda te: te[0])
                  if self.target_condition(e)]
            targets[k] = ts[0] if ts else None
        if self.drop_if_no_target:
            groups = {k: v for k, v in groups.items() if targets[k] is not None}
        cutoff = agg.CutOffTime.per_key(
            lambda k: targets.get(k) if targets.get(k) is not None else float("inf"))
        return _aggregate_groups(groups, features, cutoff,
                                 response_window=self.response_window)


# ---------------------------------------------------------------------------
# Joined (reference: JoinedDataReader.scala)
# ---------------------------------------------------------------------------

class JoinedDataReader(DataReader):
    """Record-level key join of two readers; extract fns see merged dicts.

    `join_type`: inner | left_outer | outer. Multiple right matches per
    key produce one merged record each (standard join semantics).
    """

    def __init__(self, left: DataReader, right: DataReader,
                 left_key=None, right_key=None, join_type: str = "left_outer"):
        super().__init__(records=None,
                         key=left_key or getattr(left, "key_fn", None))
        if join_type not in ("inner", "left_outer", "outer"):
            raise ValueError(f"unknown join type: {join_type}")
        self.left = left
        self.right = right
        self.left_key_fn = _key_fn(left_key) if left_key is not None else left.key_fn
        self.right_key_fn = _key_fn(right_key) if right_key is not None else right.key_fn
        self.join_type = join_type

    def read(self) -> List[Dict[str, Any]]:
        def as_dict(r):
            return dict(r) if isinstance(r, Mapping) else dict(vars(r))
        right_by_key: Dict[Any, List[Any]] = {}
        for r in self.right.read():
            right_by_key.setdefault(self.right_key_fn(r), []).append(r)
        out: List[Dict[str, Any]] = []
        matched_right = set()
        for l in self.left.read():
            k = self.left_key_fn(l)
            matches = right_by_key.get(k, [])
            if matches:
                matched_right.add(k)
                for r in matches:
                    merged = as_dict(r)
                    merged.update(as_dict(l))  # left wins on collisions
                    out.append(merged)
            elif self.join_type in ("left_outer", "outer"):
                out.append(as_dict(l))
        if self.join_type == "outer":
            for k, rs in right_by_key.items():
                if k not in matched_right:
                    out.extend(as_dict(r) for r in rs)
        return out


# ---------------------------------------------------------------------------
# Factory (reference: DataReaders.scala)
# ---------------------------------------------------------------------------

class DataReaders:
    """`DataReaders.Simple.csv(...)`-style factory (flattened)."""

    @staticmethod
    def simple(records: Iterable[Any], key=None) -> DataReader:
        return DataReader(records, key=key)

    @staticmethod
    def csv(path: str, schema: Mapping[str, Type[ft.FeatureType]],
            key=None, **kw) -> CSVProductReader:
        return CSVProductReader(path, schema, key=key, **kw)

    @staticmethod
    def csv_auto(path: str, key=None, **kw) -> CSVAutoReader:
        return CSVAutoReader(path, key=key, **kw)

    @staticmethod
    def parquet(path: str, schema: Mapping[str, Type[ft.FeatureType]],
                key=None, **kw):
        from .formats import ParquetProductReader
        return ParquetProductReader(path, schema, key=key, **kw)

    @staticmethod
    def parquet_auto(path: str, key=None, **kw):
        from .formats import ParquetAutoReader
        return ParquetAutoReader(path, key=key, **kw)

    @staticmethod
    def avro(path: str, schema=None, key=None):
        from .formats import AvroReader
        return AvroReader(path, schema=schema, key=key)

    @staticmethod
    def aggregate(base: Any, key, time,
                  cutoff: Optional[agg.CutOffTime] = None) -> AggregateDataReader:
        return AggregateDataReader(base, key, time, cutoff)

    @staticmethod
    def conditional(base: Any, key, time, target_condition,
                    response_window: Optional[float] = None,
                    drop_if_no_target: bool = True) -> ConditionalDataReader:
        return ConditionalDataReader(base, key, time, target_condition,
                                     response_window, drop_if_no_target)

    @staticmethod
    def joined(left: DataReader, right: DataReader, left_key=None,
               right_key=None, join_type: str = "left_outer") -> JoinedDataReader:
        return JoinedDataReader(left, right, left_key, right_key, join_type)
