"""Host-side columnar dataset (the port's copy of
``transmogrifai_tpu/dataset.py``; host-only, unchanged).

The reference rides on Spark DataFrames (reference: utils/.../RichDataset,
readers/DataReader.scala generateDataFrame). TPU-first replacement: a thin
immutable columnar table on numpy — scalar numeric columns as float64 (NaN =
missing), everything else as object arrays, and vectorized features
(OPVector) as dense 2D float32 matrices ready for device transfer. All heavy
compute happens after the matrices move to the device; the Dataset is
deliberately simple host glue, not a query engine.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Type

import numpy as np

from .features import types as ft

_NUMERIC = (ft.OPNumeric,)


def _is_numeric(t: Type[ft.FeatureType]) -> bool:
    return issubclass(t, _NUMERIC)


def column_to_numpy(values: Sequence[Any], ftype: Type[ft.FeatureType]) -> np.ndarray:
    """Convert raw python values to the canonical column representation."""
    if issubclass(ftype, ft.SparseIndices):
        rows = [tuple(v) if v is not None else () for v in values]
        widths = {len(r) for r in rows if len(r) > 0}
        if len(widths) > 1:
            raise ValueError(f"ragged SparseIndices rows: {sorted(widths)}")
        width = widths.pop() if widths else 0
        out = np.zeros((len(rows), width), dtype=np.int32)
        for i, r in enumerate(rows):
            if r:
                out[i] = r
        return out
    if issubclass(ftype, ft.OPVector):
        rows = [tuple(v) if v is not None else () for v in values]
        widths = {len(r) for r in rows if len(r) > 0}
        if len(widths) > 1:
            raise ValueError(f"ragged OPVector rows: widths {sorted(widths)}")
        width = widths.pop() if widths else 0
        out = np.zeros((len(rows), width), dtype=np.float32)
        for i, r in enumerate(rows):
            if r:  # empty vector rows stay zero (missing = zero vector)
                out[i] = r
        return out
    if _is_numeric(ftype):
        out = np.full(len(values), np.nan, dtype=np.float64)
        for i, v in enumerate(values):
            if isinstance(v, ft.FeatureType):
                v = v.value
            if v is not None:
                out[i] = float(v)
        return out
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        if isinstance(v, ft.FeatureType):
            v = v.value
        # normalize empties to None for text, keep () / {} for collections
        if isinstance(v, str) and issubclass(ftype, ft.Text):
            out[i] = v
        else:
            out[i] = ftype(v).value if v is not None else ftype.empty().value if not ftype.nullable else None
    return out


class Dataset:
    """Immutable named-column table with a FeatureType schema."""

    def __init__(self, columns: Mapping[str, np.ndarray],
                 schema: Mapping[str, Type[ft.FeatureType]],
                 manifests: Optional[Mapping[str, Any]] = None):
        if set(columns) != set(schema):
            raise ValueError("columns and schema must have identical keys")
        n = {len(c) for c in columns.values()}
        if len(n) > 1:
            raise ValueError(f"ragged columns: {sorted(n)}")
        self._columns: Dict[str, np.ndarray] = dict(columns)
        self._schema: Dict[str, Type[ft.FeatureType]] = dict(schema)
        self._manifests: Dict[str, Any] = {k: v for k, v in (manifests or {}).items()
                                           if k in self._columns}
        self._n_rows = n.pop() if n else 0

    # -- construction ----------------------------------------------------
    @staticmethod
    def from_dict(data: Mapping[str, Sequence[Any]],
                  schema: Mapping[str, Type[ft.FeatureType]]) -> "Dataset":
        cols = {}
        for k, v in data.items():
            try:
                cols[k] = column_to_numpy(v, schema[k])
            except Exception as e:
                raise type(e)(f"column {k!r} ({schema[k].__name__}): {e}") from e
        return Dataset(cols, schema)

    @staticmethod
    def from_rows(rows: Iterable[Mapping[str, Any]],
                  schema: Mapping[str, Type[ft.FeatureType]]) -> "Dataset":
        rows = list(rows)
        data = {k: [r.get(k) for r in rows] for k in schema}
        return Dataset.from_dict(data, schema)

    # -- basic accessors -------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self._n_rows

    @property
    def schema(self) -> Dict[str, Type[ft.FeatureType]]:
        return dict(self._schema)

    @property
    def column_names(self) -> List[str]:
        return list(self._columns)

    def column(self, name: str) -> np.ndarray:
        return self._columns[name]

    def ftype(self, name: str) -> Type[ft.FeatureType]:
        return self._schema[name]

    def manifest(self, name: str):
        """ColumnManifest for an OPVector column, or None."""
        return self._manifests.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def __len__(self) -> int:
        return self._n_rows

    # -- functional updates ---------------------------------------------
    def with_column(self, name: str, values: np.ndarray,
                    ftype: Type[ft.FeatureType], manifest=None) -> "Dataset":
        cols = dict(self._columns)
        sch = dict(self._schema)
        man = dict(self._manifests)
        cols[name] = values
        sch[name] = ftype
        if manifest is not None:
            man[name] = manifest
        elif name in man:
            del man[name]
        return Dataset(cols, sch, man)

    def select(self, names: Sequence[str]) -> "Dataset":
        return Dataset({n: self._columns[n] for n in names},
                       {n: self._schema[n] for n in names},
                       {n: m for n, m in self._manifests.items() if n in set(names)})

    def drop(self, names: Sequence[str]) -> "Dataset":
        keep = [n for n in self._columns if n not in set(names)]
        return self.select(keep)

    def take(self, idx: np.ndarray) -> "Dataset":
        return Dataset({n: c[idx] for n, c in self._columns.items()}, self._schema,
                       self._manifests)

    def head(self, k: int) -> "Dataset":
        return self.take(np.arange(min(k, self._n_rows)))

    # -- row views (local scoring / tests) -------------------------------
    def rows(self) -> Iterable[Dict[str, Any]]:
        names = list(self._columns)
        for i in range(self._n_rows):
            yield {n: self.raw_value(n, i) for n in names}

    def raw_value(self, name: str, i: int) -> Any:
        c = self._columns[name]
        t = self._schema[name]
        if issubclass(t, ft.OPVector):
            return tuple(float(x) for x in c[i])
        v = c[i]
        if _is_numeric(t):
            if np.isnan(v):
                return None
            if issubclass(t, ft.Binary):
                return bool(v)
            if issubclass(t, ft.Integral):
                return int(v)
            return float(v)
        return v

    def typed_value(self, name: str, i: int) -> ft.FeatureType:
        return self._schema[name](self.raw_value(name, i))

    def pycolumn(self, name: str) -> List[Any]:
        """Whole-column raw_value conversion in one vectorized pass —
        `ndarray.tolist()` converts cells in C, so per-cell cost is just
        the NaN->None / bool / int normalization (the row-at-a-time
        `raw_value` path pays python dispatch per cell on top)."""
        c = self._columns[name]
        t = self._schema[name]
        if issubclass(t, ft.OPVector):
            return [tuple(row) for row in c.tolist()]
        vals = c.tolist()
        if _is_numeric(t):
            if issubclass(t, ft.Binary):
                return [None if v != v else bool(v) for v in vals]
            if issubclass(t, ft.Integral):
                return [None if v != v else int(v) for v in vals]
            return [None if v != v else v for v in vals]
        return vals

    def to_pylist(self, name: str) -> List[Any]:
        return self.pycolumn(name)

    def show(self, n: int = 20, max_width: int = 24) -> str:
        """Aligned-table preview of the first n rows (the reference's
        RichDataset/table pretty-print util). Returns the string AND
        prints it, mirroring Spark's df.show() ergonomics."""
        names = list(self._columns)
        k = max(0, min(n, self._n_rows))
        max_width = max(4, max_width)   # room for the "..." ellipsis

        def fmt(v):
            if v is None:
                return "null"
            if isinstance(v, float):
                s = f"{v:.6g}"
            elif isinstance(v, tuple):
                # slice BEFORE stringifying: a 2^20-dim vector cell must
                # not build a megabyte string to keep ~21 chars
                head_ = v[:max_width // 2 + 1]
                s = "[" + ", ".join(f"{x:.4g}" if isinstance(x, float)
                                    else str(x) for x in head_)
                s += ", ...]" if len(v) > len(head_) else "]"
            else:
                s = str(v)
            return s if len(s) <= max_width else s[:max_width - 3] + "..."

        # one vectorized conversion per column (pycolumn), not one
        # python dispatch per cell
        h = self.head(k)
        by_col = {c: h.pycolumn(c) for c in names}
        cells = [[fmt(by_col[c][i]) for c in names] for i in range(k)]
        widths = [max([len(c)] + [len(row[j]) for row in cells])
                  for j, c in enumerate(names)]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        lines = [sep,
                 "|" + "|".join(f" {c:<{w}} "
                                for c, w in zip(names, widths)) + "|",
                 sep]
        for row in cells:
            lines.append("|" + "|".join(
                f" {v:<{w}} " for v, w in zip(row, widths)) + "|")
        lines.append(sep)
        if self._n_rows > k:
            lines.append(f"showing {k} of {self._n_rows} rows")
        out = "\n".join(lines)
        print(out)
        return out

    def __repr__(self):
        cols = ", ".join(f"{n}:{t.__name__}" for n, t in self._schema.items())
        return f"Dataset(n={self._n_rows}, [{cols}])"
