"""Event-time monoid aggregators (the port's copy of
``transmogrifai_tpu/features/aggregators.py``).

Reference: features/src/main/scala/com/salesforce/op/aggregators/*.scala
(MonoidAggregatorDefaults, FeatureAggregator, CutOffTime) — Algebird
monoids that fold a key's event records into one feature value, with a
time cutoff splitting predictor history from response window.

TPU-first note: aggregation is host-side data preparation (it happens
once per training run, before any device transfer), so these are plain
Python monoids — the device never sees un-aggregated events.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Type

from . import types as ft


class MonoidAggregator:
    """A fold: zero ⊕ prepare(v0) ⊕ prepare(v1) ⊕ … → present(acc).

    `prepare` may return None to skip a value (missing events are
    absorbed); `present` may return None to mean "empty feature".
    """

    name: str = "abstract"

    def zero(self) -> Any:
        return None

    def prepare(self, v: Any) -> Any:
        return v

    def combine(self, a: Any, b: Any) -> Any:
        raise NotImplementedError

    def present(self, acc: Any) -> Any:
        return acc

    def __call__(self, values: Sequence[Any]) -> Any:
        acc = self.zero()
        for v in values:
            if isinstance(v, ft.FeatureType):
                v = v.value
            p = self.prepare(v)
            if p is None:
                continue
            acc = p if acc is None else self.combine(acc, p)
        return self.present(acc)


class _Num(MonoidAggregator):
    def prepare(self, v):
        return None if v is None else float(v)


class SumAggregator(_Num):
    name = "sum"

    def combine(self, a, b):
        return a + b


class MeanAggregator(_Num):
    name = "mean"

    def prepare(self, v):
        return None if v is None else (float(v), 1)

    def combine(self, a, b):
        return (a[0] + b[0], a[1] + b[1])

    def present(self, acc):
        return None if acc is None else acc[0] / acc[1]


class MinAggregator(_Num):
    name = "min"

    def combine(self, a, b):
        return min(a, b)


class MaxAggregator(_Num):
    name = "max"

    def combine(self, a, b):
        return max(a, b)


class FirstAggregator(MonoidAggregator):
    name = "first"

    def combine(self, a, b):
        return a


class LastAggregator(MonoidAggregator):
    name = "last"

    def combine(self, a, b):
        return b


class OrAggregator(MonoidAggregator):
    name = "or"

    def prepare(self, v):
        return None if v is None else bool(v)

    def combine(self, a, b):
        return a or b


class AndAggregator(OrAggregator):
    name = "and"

    def combine(self, a, b):
        return a and b


class ConcatTextAggregator(MonoidAggregator):
    """Text concatenation with a separator (ConcatTextWithSeparator)."""

    name = "concat"

    def __init__(self, separator: str = " "):
        self.separator = separator

    def prepare(self, v):
        return None if v is None or v == "" else str(v)

    def combine(self, a, b):
        return a + self.separator + b


class ConcatListAggregator(MonoidAggregator):
    name = "concat_list"

    def prepare(self, v):
        if v is None:
            return None
        return tuple(v) if not isinstance(v, tuple) else v

    def combine(self, a, b):
        return a + b


class UnionSetAggregator(MonoidAggregator):
    name = "union"

    def prepare(self, v):
        if v is None:
            return None
        return frozenset(v)

    def combine(self, a, b):
        return a | b


class CollectAggregator(MonoidAggregator):
    """Collect scalar events into a list feature (e.g. Date -> DateList)."""

    name = "collect"

    def prepare(self, v):
        return None if v is None else (v,)

    def combine(self, a, b):
        return a + b


class GeoMidpointAggregator(MonoidAggregator):
    """Geographic midpoint via unit-sphere mean (GeolocationMidpoint)."""

    name = "midpoint"

    def prepare(self, v):
        if v is None or len(v) == 0:
            return None
        g = ft.Geolocation(v)
        x, y, z = g.to_unit_sphere()
        return (x, y, z, g.accuracy or 0.0, 1)

    def combine(self, a, b):
        return tuple(ai + bi for ai, bi in zip(a, b))

    def present(self, acc):
        import math
        if acc is None:
            return None
        x, y, z, accsum, n = acc
        x, y, z = x / n, y / n, z / n
        hyp = math.hypot(x, y)
        if hyp == 0 and z == 0:
            return None
        lat = math.degrees(math.atan2(z, hyp))
        lon = math.degrees(math.atan2(y, x))
        return (lat, lon, accsum / n)


class ModeAggregator(MonoidAggregator):
    """Most frequent non-null value (ties -> first seen)."""

    name = "mode"

    def prepare(self, v):
        return None if v is None else ((v, 1),)

    def combine(self, a, b):
        counts: Dict[Any, int] = {}
        order: List[Any] = []
        for v, c in a + b:
            if v not in counts:
                order.append(v)
                counts[v] = 0
            counts[v] += c
        return tuple((v, counts[v]) for v in order)

    def present(self, acc):
        if acc is None:
            return None
        return max(acc, key=lambda vc: vc[1])[0]


class MergeMapAggregator(MonoidAggregator):
    """Key-union map merge; colliding values combined by an inner monoid."""

    name = "merge"

    def __init__(self, inner: Optional[MonoidAggregator] = None):
        self.inner = inner or LastAggregator()

    def prepare(self, v):
        if v is None or len(v) == 0:
            return None
        out = {}
        for k, x in v.items():
            p = self.inner.prepare(x)
            if p is not None:
                out[k] = p
        return out or None

    def combine(self, a, b):
        out = dict(a)
        for k, v in b.items():
            out[k] = self.inner.combine(out[k], v) if k in out else v
        return out

    def present(self, acc):
        if acc is None:
            return None
        return {k: self.inner.present(v) for k, v in acc.items()}


AGGREGATORS: Dict[str, Callable[[], MonoidAggregator]] = {
    "sum": SumAggregator,
    "mean": MeanAggregator,
    "min": MinAggregator,
    "max": MaxAggregator,
    "first": FirstAggregator,
    "last": LastAggregator,
    "or": OrAggregator,
    "and": AndAggregator,
    "concat": ConcatTextAggregator,
    "concat_list": ConcatListAggregator,
    "union": UnionSetAggregator,
    "collect": CollectAggregator,
    "midpoint": GeoMidpointAggregator,
    "mode": ModeAggregator,
    "merge": MergeMapAggregator,
}


def by_name(name: str) -> MonoidAggregator:
    try:
        return AGGREGATORS[name]()
    except KeyError:
        raise ValueError(f"unknown aggregator: {name!r} "
                         f"(known: {sorted(AGGREGATORS)})") from None


def default_for(wtype: Type[ft.FeatureType]) -> MonoidAggregator:
    """Default monoid per feature type (MonoidAggregatorDefaults parity):
    numerics sum, Binary OR, Date latest, text concat, picklists mode,
    lists concat, sets union, geo midpoint, maps key-union merge with the
    value type's own default as the inner monoid."""
    if issubclass(wtype, ft.MultiPickListMap):
        return MergeMapAggregator(UnionSetAggregator())
    if issubclass(wtype, ft.GeolocationMap):
        return MergeMapAggregator(LastAggregator())
    if issubclass(wtype, (ft.RealMap, ft.IntegralMap)) and not issubclass(wtype, (ft.DateMap,)):
        return MergeMapAggregator(SumAggregator())
    if issubclass(wtype, ft.BinaryMap):
        return MergeMapAggregator(OrAggregator())
    if issubclass(wtype, ft.OPMap) and not issubclass(wtype, ft.Prediction):
        return MergeMapAggregator(LastAggregator())
    if issubclass(wtype, ft.Binary):
        return OrAggregator()
    if issubclass(wtype, ft.Date):  # Date/DateTime: latest event wins
        return MaxAggregator()
    if issubclass(wtype, ft.OPNumeric):
        return SumAggregator()
    if issubclass(wtype, (ft.PickList, ft.ComboBox, ft.ID)):
        return ModeAggregator()
    if issubclass(wtype, ft.Geolocation):
        return GeoMidpointAggregator()
    if issubclass(wtype, ft.Text):
        return ConcatTextAggregator()
    if issubclass(wtype, ft.OPList):
        return ConcatListAggregator()
    if issubclass(wtype, ft.OPSet):
        return UnionSetAggregator()
    return LastAggregator()


def resolve(name: Optional[str], wtype: Type[ft.FeatureType]) -> MonoidAggregator:
    return by_name(name) if name else default_for(wtype)


class CutOffTime:
    """Splits a key's event timeline: predictors see events strictly before
    the cutoff, responses see events at/after it (CutOffTime.scala)."""

    def __init__(self, fn: Optional[Callable[[Any], Optional[float]]]):
        self._fn = fn

    @staticmethod
    def no_cutoff() -> "CutOffTime":
        return CutOffTime(None)

    @staticmethod
    def at(timestamp: float) -> "CutOffTime":
        return CutOffTime(lambda key: float(timestamp))

    @staticmethod
    def per_key(fn: Callable[[Any], Optional[float]]) -> "CutOffTime":
        return CutOffTime(fn)

    def for_key(self, key: Any) -> Optional[float]:
        return None if self._fn is None else self._fn(key)
