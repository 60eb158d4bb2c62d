"""Lazy feature DAG nodes and builders (the port's copy of
``transmogrifai_tpu/features/feature.py``; host-only, unchanged).

Reference: features/src/main/scala/com/salesforce/op/features/Feature.scala,
FeatureLike.scala, FeatureBuilder.scala, TransientFeature.scala.

A Feature is an immutable, lazy handle: (name, type, origin stage, parents,
is_response, uid). Nothing executes until a Workflow materializes the DAG.
DSL methods (tokenize, pivot, vectorize, transmogrify, sanity_check, ...)
are attached by the ops modules via `register_dsl` so the dependency points
ops -> features, never the reverse.
"""
from __future__ import annotations

import itertools
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

from . import types as ft

_uid_counters: Dict[str, itertools.count] = {}


def make_uid(prefix: str) -> str:
    c = _uid_counters.setdefault(prefix, itertools.count())
    return f"{prefix}_{next(c):012d}"


def reset_uids() -> None:
    """Deterministic uids for tests."""
    _uid_counters.clear()


class Feature:
    """A node in the lazy feature DAG."""

    __slots__ = ("name", "wtype", "is_response", "origin_stage", "parents", "uid")

    def __init__(self, name: str, wtype: Type[ft.FeatureType],
                 origin_stage: Optional[Any] = None,
                 parents: Sequence["Feature"] = (),
                 is_response: bool = False,
                 uid: Optional[str] = None):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "wtype", wtype)
        object.__setattr__(self, "origin_stage", origin_stage)
        object.__setattr__(self, "parents", tuple(parents))
        object.__setattr__(self, "is_response", bool(is_response))
        object.__setattr__(self, "uid", uid or make_uid("Feature"))

    def __setattr__(self, *a):
        raise AttributeError("Feature is immutable")

    @property
    def is_raw(self) -> bool:
        from ..stages.generator import FeatureGeneratorStage
        return self.origin_stage is None or isinstance(self.origin_stage, FeatureGeneratorStage)

    def raw_features(self) -> List["Feature"]:
        """All raw ancestors (leaves of the DAG), deduped, stable order."""
        seen: Dict[str, Feature] = {}

        def walk(f: Feature):
            if f.is_raw:
                seen.setdefault(f.uid, f)
            else:
                for p in f.parents:
                    walk(p)
        walk(self)
        return list(seen.values())

    def all_features(self) -> List["Feature"]:
        seen: Dict[str, Feature] = {}

        def walk(f: Feature):
            if f.uid in seen:
                return
            seen[f.uid] = f
            for p in f.parents:
                walk(p)
        walk(self)
        return list(seen.values())

    def history(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "type": self.wtype.__name__,
            "isResponse": self.is_response,
            "originStage": getattr(self.origin_stage, "uid", None),
            "parents": [p.name for p in self.parents],
            "uid": self.uid,
        }

    def __repr__(self):
        role = "response" if self.is_response else "predictor"
        return f"Feature<{self.wtype.__name__}>({self.name!r}, {role})"

    def __hash__(self):
        return hash(self.uid)

    def __eq__(self, other):
        return isinstance(other, Feature) and other.uid == self.uid

    # -- DSL attachment (reference: core/.../dsl/Rich*Feature.scala) ------
    @classmethod
    def register_dsl(cls, name: str, fn: Callable, types: Tuple[Type[ft.FeatureType], ...] = (ft.FeatureType,)):
        def method(self, *args, **kwargs):
            if not issubclass(self.wtype, types):
                allowed = "/".join(t.__name__ for t in types)
                raise TypeError(f".{name}() requires a {allowed} feature, got {self.wtype.__name__}")
            return fn(self, *args, **kwargs)
        method.__name__ = name
        setattr(cls, name, method)


class TransientFeature:
    """Serializable stub of a Feature carried inside fitted stages.

    Reference: features/.../TransientFeature.scala — stages must not close
    over the whole DAG when persisted.
    """

    __slots__ = ("name", "wtype", "is_response", "uid")

    def __init__(self, name: str, wtype: Type[ft.FeatureType],
                 is_response: bool = False, uid: str = ""):
        self.name = name
        self.wtype = wtype
        self.is_response = is_response
        self.uid = uid

    @staticmethod
    def of(f: Feature) -> "TransientFeature":
        return TransientFeature(f.name, f.wtype, f.is_response, f.uid)

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "type": self.wtype.__name__,
                "isResponse": self.is_response, "uid": self.uid}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "TransientFeature":
        return TransientFeature(d["name"], ft.FeatureTypeFactory.by_name(d["type"]),
                                d["isResponse"], d["uid"])


def column_extract(name: str) -> Callable[[Any], Any]:
    """Plain same-named column lookup, tagged with `.column_name` so
    columnar readers can recognize it and skip per-row extraction."""
    fn = lambda row: row.get(name)  # noqa: E731
    fn.column_name = name
    return fn


# ---------------------------------------------------------------------------
# FeatureBuilder (reference: features/.../FeatureBuilder.scala)
# ---------------------------------------------------------------------------

class FeatureBuilderWithExtract:
    def __init__(self, name: str, wtype: Type[ft.FeatureType],
                 extract_fn: Callable[[Any], Any], aggregator: Optional[str] = None):
        self.name = name
        self.wtype = wtype
        self.extract_fn = extract_fn
        self.aggregator = aggregator

    def aggregate(self, aggregator: str) -> "FeatureBuilderWithExtract":
        self.aggregator = aggregator
        return self

    def _build(self, is_response: bool) -> Feature:
        from ..stages.generator import FeatureGeneratorStage
        stage = FeatureGeneratorStage(
            name=self.name, wtype=self.wtype, extract_fn=self.extract_fn,
            aggregator=self.aggregator, is_response=is_response)
        return stage.output

    def as_predictor(self) -> Feature:
        return self._build(is_response=False)

    def as_response(self) -> Feature:
        return self._build(is_response=True)

    # scala-style aliases
    asPredictor = as_predictor
    asResponse = as_response


class _FeatureBuilderOfType:
    def __init__(self, wtype: Type[ft.FeatureType], name: str):
        self.wtype = wtype
        self.name = name

    def extract(self, fn: Callable[[Any], Any]) -> FeatureBuilderWithExtract:
        return FeatureBuilderWithExtract(self.name, self.wtype, fn)

    def from_column(self) -> FeatureBuilderWithExtract:
        """Extract the identically-named field from a row mapping."""
        return FeatureBuilderWithExtract(self.name, self.wtype,
                                         column_extract(self.name))


class _FeatureBuilderMeta(type):
    def __getattr__(cls, type_name: str):
        t = ft.FeatureTypeFactory.by_name(type_name)  # raises on unknown
        return lambda name: _FeatureBuilderOfType(t, name)


class FeatureBuilder(metaclass=_FeatureBuilderMeta):
    """`FeatureBuilder.Text("name").extract(fn).as_predictor()` plus
    schema-driven inference (`from_dataset`)."""

    @staticmethod
    def of(wtype: Type[ft.FeatureType], name: str) -> _FeatureBuilderOfType:
        return _FeatureBuilderOfType(wtype, name)

    @staticmethod
    def from_dataset(dataset, response: str) -> Tuple[Feature, List[Feature]]:
        """Infer raw features from a Dataset schema.

        Mirrors FeatureBuilder.fromDataFrame (reference:
        features/.../FeatureBuilder.scala): the response becomes RealNN, all
        other columns become predictors of their schema type.
        """
        if response not in dataset.schema:
            raise ValueError(f"response column {response!r} not in dataset")
        resp = FeatureBuilder.of(ft.RealNN, response).from_column().as_response()
        preds = [FeatureBuilder.of(t, n).from_column().as_predictor()
                 for n, t in dataset.schema.items() if n != response]
        return resp, preds

    @staticmethod
    def from_schema(schema: Dict[str, Type[ft.FeatureType]], response: str) -> Tuple[Feature, List[Feature]]:
        resp = FeatureBuilder.of(ft.RealNN, response).from_column().as_response()
        preds = [FeatureBuilder.of(t, n).from_column().as_predictor()
                 for n, t in schema.items() if n != response]
        return resp, preds
