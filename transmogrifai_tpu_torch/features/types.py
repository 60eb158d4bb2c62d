"""Typed feature system (the port's copy of
``transmogrifai_tpu/features/types.py``; host-only, unchanged).

Re-creation of the reference's strongly-typed feature hierarchy
(reference: features/src/main/scala/com/salesforce/op/features/types/ —
FeatureType.scala, Numerics.scala, Text.scala, Lists.scala, Maps.scala,
OPVector.scala) as lightweight Python value wrappers plus a type registry.

Design notes (TPU-first): these classes are *type tags with value
semantics* used at API boundaries (FeatureBuilder extract functions, local
row-scoring, tests). Bulk data never lives as per-row wrapper objects —
datasets store columns as numpy arrays tagged with the FeatureType class in
their schema, and vectorized features live as device-resident tensors.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Type

__all__ = [
    "FeatureType", "FeatureTypeFactory",
    # numerics
    "OPNumeric", "Real", "RealNN", "Integral", "Binary", "Date", "DateTime",
    "Currency", "Percent",
    # text
    "Text", "Email", "Phone", "URL", "ID", "PickList", "ComboBox", "Base64",
    "TextArea", "City", "Street", "State", "Country", "PostalCode",
    # collections
    "OPList", "TextList", "DateList", "DateTimeList", "OPSet", "MultiPickList",
    "Geolocation",
    # maps
    "OPMap", "TextMap", "RealMap", "IntegralMap", "BinaryMap", "PickListMap",
    "ComboBoxMap", "EmailMap", "PhoneMap", "URLMap", "IDMap", "Base64Map",
    "TextAreaMap", "CityMap", "StreetMap", "StateMap", "CountryMap",
    "PostalCodeMap", "CurrencyMap", "PercentMap", "DateMap", "DateTimeMap",
    "MultiPickListMap", "GeolocationMap",
    # vector / prediction
    "OPVector", "Prediction",
]


class FeatureTypeError(TypeError):
    pass


_REGISTRY: Dict[str, Type["FeatureType"]] = {}


class FeatureType:
    """Base of the feature-type hierarchy.

    Instances are immutable wrappers over an optional value; ``None`` encodes
    the empty (missing) value, mirroring the reference's Option semantics.
    """

    __slots__ = ("_value",)
    #: subclasses that forbid empty values override this
    nullable: bool = True

    def __init__(self, value: Any = None):
        if isinstance(value, FeatureType):
            value = value.value
        object.__setattr__(self, "_value", self._validate(value))

    # -- subclass hooks -------------------------------------------------
    @classmethod
    def _validate(cls, value: Any) -> Any:
        if value is None and not cls.nullable:
            raise FeatureTypeError(f"{cls.__name__} cannot be empty")
        return value

    # -- common API -----------------------------------------------------
    @property
    def value(self) -> Any:
        return self._value

    @property
    def is_empty(self) -> bool:
        v = self._value
        if v is None:
            return True
        if isinstance(v, (str, tuple, list, dict, set, frozenset)):
            return len(v) == 0
        return False

    @property
    def v(self) -> Any:  # short alias, mirrors the reference DSL
        return self._value

    @classmethod
    def type_name(cls) -> str:
        return cls.__name__

    @classmethod
    def empty(cls) -> "FeatureType":
        return cls(None) if cls.nullable else cls(cls._empty_value())

    @classmethod
    def _empty_value(cls):
        raise FeatureTypeError(f"{cls.__name__} cannot be empty")

    def __setattr__(self, *a):  # immutable
        raise AttributeError(f"{type(self).__name__} is immutable")

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self._value == other._value

    def __hash__(self):
        v = self._value
        if isinstance(v, (list, dict, set)):
            v = repr(v)
        return hash((type(self).__name__, v))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._value!r})"

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        _REGISTRY[cls.__name__] = cls


# ---------------------------------------------------------------------------
# Numerics (reference: features/.../types/Numerics.scala)
# ---------------------------------------------------------------------------

class OPNumeric(FeatureType):
    """Base numeric type; value is a python float/int or None."""

    def to_float(self) -> Optional[float]:
        return None if self._value is None else float(self._value)


class Real(OPNumeric):
    @classmethod
    def _validate(cls, value):
        value = super()._validate(value)
        if value is None:
            return None
        if isinstance(value, bool):
            return float(value)
        if isinstance(value, (int, float)):
            f = float(value)
            if math.isnan(f):
                if not cls.nullable:
                    raise FeatureTypeError(f"{cls.__name__} cannot be NaN")
                return None
            return f
        raise FeatureTypeError(f"Real requires a number, got {value!r}")


class RealNN(Real):
    """Non-nullable real — the required response type for model fitting."""
    nullable = False


class Currency(Real):
    pass


class Percent(Real):
    pass


class Integral(OPNumeric):
    @classmethod
    def _validate(cls, value):
        value = super()._validate(value)
        if value is None:
            return None
        if isinstance(value, bool):
            return int(value)
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
        raise FeatureTypeError(f"Integral requires an int, got {value!r}")


class Date(Integral):
    """Milliseconds since epoch (day resolution by convention)."""


class DateTime(Date):
    pass


class Binary(OPNumeric):
    @classmethod
    def _validate(cls, value):
        value = super()._validate(value)
        if value is None:
            return None
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)) and value in (0, 1):
            return bool(value)
        raise FeatureTypeError(f"Binary requires a bool, got {value!r}")

    def to_float(self):
        return None if self._value is None else float(self._value)


# ---------------------------------------------------------------------------
# Text (reference: features/.../types/Text.scala)
# ---------------------------------------------------------------------------

class Text(FeatureType):
    @classmethod
    def _validate(cls, value):
        value = super()._validate(value)
        if value is None:
            return None
        if isinstance(value, str):
            return value
        raise FeatureTypeError(f"{cls.__name__} requires a str, got {value!r}")


class Email(Text):
    @property
    def prefix(self) -> Optional[str]:
        s = self._split()
        return s[0] if s else None

    @property
    def domain(self) -> Optional[str]:
        s = self._split()
        return s[1] if s else None

    def _split(self):
        v = self._value
        if not v or "@" not in v:
            return None
        pre, _, dom = v.partition("@")
        if not pre or not dom:
            return None
        return pre, dom


class Phone(Text):
    pass


class URL(Text):
    @property
    def domain(self) -> Optional[str]:
        v = self._value
        if not v:
            return None
        rest = v.split("://", 1)[-1]
        dom = rest.split("/", 1)[0].split("?", 1)[0]
        return dom or None

    @property
    def protocol(self) -> Optional[str]:
        v = self._value
        if not v or "://" not in v:
            return None
        return v.split("://", 1)[0]

    @property
    def is_valid(self) -> bool:
        d = self.domain
        p = self.protocol
        return bool(d) and "." in d and (p is None or p in ("http", "https", "ftp"))


class ID(Text):
    pass


class PickList(Text):
    """Categorical with a (conceptually) closed vocabulary."""


class ComboBox(Text):
    """Categorical with an open vocabulary."""


class Base64(Text):
    pass


class TextArea(Text):
    pass


class City(Text):
    pass


class Street(Text):
    pass


class State(Text):
    pass


class Country(Text):
    pass


class PostalCode(Text):
    pass


# ---------------------------------------------------------------------------
# Collections (reference: features/.../types/Lists.scala)
# ---------------------------------------------------------------------------

def _coerce_item(cls_name: str, item_type: Type, v: Any) -> Any:
    """Enforce/coerce a collection element to the declared item type."""
    if item_type is object:
        return v
    if item_type is float:
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise FeatureTypeError(f"{cls_name} element must be a number, got {v!r}")
        return float(v)
    if item_type is int:
        if isinstance(v, bool) or not isinstance(v, int):
            if isinstance(v, float) and v.is_integer():
                return int(v)
            raise FeatureTypeError(f"{cls_name} element must be an int, got {v!r}")
        return v
    if item_type is bool:
        if isinstance(v, bool):
            return v
        if isinstance(v, (int, float)) and v in (0, 1):
            return bool(v)
        raise FeatureTypeError(f"{cls_name} element must be a bool, got {v!r}")
    if item_type is str:
        if not isinstance(v, str):
            raise FeatureTypeError(f"{cls_name} element must be a str, got {v!r}")
        return v
    if not isinstance(v, item_type):
        raise FeatureTypeError(
            f"{cls_name} element must be {item_type.__name__}, got {v!r}")
    return v


class OPList(FeatureType):
    item_type: Type = object

    @classmethod
    def _validate(cls, value):
        value = FeatureType._validate.__func__(cls, value)
        if value is None:
            return ()
        if isinstance(value, (list, tuple)):
            return tuple(_coerce_item(cls.__name__, cls.item_type, v) for v in value)
        raise FeatureTypeError(f"{cls.__name__} requires a sequence")

    @property
    def is_empty(self) -> bool:
        return len(self._value) == 0


class TextList(OPList):
    item_type = str


class DateList(OPList):
    item_type = int


class DateTimeList(DateList):
    pass


class OPSet(FeatureType):
    item_type: Type = object

    @classmethod
    def _validate(cls, value):
        value = FeatureType._validate.__func__(cls, value)
        if value is None:
            return frozenset()
        if isinstance(value, (set, frozenset, list, tuple)):
            return frozenset(_coerce_item(cls.__name__, cls.item_type, v)
                             for v in value)
        raise FeatureTypeError(f"{cls.__name__} requires a set")

    @property
    def is_empty(self) -> bool:
        return len(self._value) == 0


class MultiPickList(OPSet):
    item_type = str


class Geolocation(OPList):
    """(lat, lon, accuracy) triple; empty tuple when missing.

    Reference: features/.../types/Lists.scala (Geolocation).
    """
    item_type = float

    @classmethod
    def _validate(cls, value):
        value = super()._validate(value)
        if len(value) == 0:
            return ()
        if len(value) != 3:
            raise FeatureTypeError("Geolocation requires (lat, lon, accuracy)")
        lat, lon, acc = (float(x) for x in value)
        if not (-90.0 <= lat <= 90.0):
            raise FeatureTypeError(f"latitude out of range: {lat}")
        if not (-180.0 <= lon <= 180.0):
            raise FeatureTypeError(f"longitude out of range: {lon}")
        return (lat, lon, acc)

    @property
    def lat(self) -> Optional[float]:
        return self._value[0] if self._value else None

    @property
    def lon(self) -> Optional[float]:
        return self._value[1] if self._value else None

    @property
    def accuracy(self) -> Optional[float]:
        return self._value[2] if self._value else None

    def to_unit_sphere(self) -> Optional[Tuple[float, float, float]]:
        """Project onto the unit sphere (x, y, z) — the vectorization basis."""
        if not self._value:
            return None
        lat, lon = math.radians(self._value[0]), math.radians(self._value[1])
        return (math.cos(lat) * math.cos(lon),
                math.cos(lat) * math.sin(lon),
                math.sin(lat))


# ---------------------------------------------------------------------------
# Maps (reference: features/.../types/Maps.scala) — one per scalar type
# ---------------------------------------------------------------------------

class OPMap(FeatureType):
    value_type: Type = object

    @classmethod
    def _validate(cls, value):
        value = FeatureType._validate.__func__(cls, value)
        if value is None:
            return {}
        if isinstance(value, dict):
            return {str(k): _coerce_item(cls.__name__, cls.value_type, v)
                    for k, v in value.items()}
        raise FeatureTypeError(f"{cls.__name__} requires a dict")

    @property
    def is_empty(self) -> bool:
        return len(self._value) == 0

    def __eq__(self, other):
        return type(self) is type(other) and self._value == other._value

    def __hash__(self):
        return hash((type(self).__name__, tuple(sorted(self._value.items(), key=repr))))


class TextMap(OPMap):
    value_type = str


class EmailMap(TextMap):
    pass


class PhoneMap(TextMap):
    pass


class URLMap(TextMap):
    pass


class IDMap(TextMap):
    pass


class PickListMap(TextMap):
    pass


class ComboBoxMap(TextMap):
    pass


class Base64Map(TextMap):
    pass


class TextAreaMap(TextMap):
    pass


class CityMap(TextMap):
    pass


class StreetMap(TextMap):
    pass


class StateMap(TextMap):
    pass


class CountryMap(TextMap):
    pass


class PostalCodeMap(TextMap):
    pass


class RealMap(OPMap):
    value_type = float


class CurrencyMap(RealMap):
    pass


class PercentMap(RealMap):
    pass


class IntegralMap(OPMap):
    value_type = int


class DateMap(IntegralMap):
    pass


class DateTimeMap(DateMap):
    pass


class BinaryMap(OPMap):
    value_type = bool


class MultiPickListMap(OPMap):
    value_type = object  # values validated below as frozensets of str

    @classmethod
    def _validate(cls, value):
        value = super()._validate(value)
        return {k: frozenset(_coerce_item(cls.__name__, str, x) for x in v)
                for k, v in value.items()}


class GeolocationMap(OPMap):
    value_type = object  # values validated below as (lat, lon, accuracy)

    @classmethod
    def _validate(cls, value):
        value = super()._validate(value)
        return {k: Geolocation(v).value for k, v in value.items()}


# ---------------------------------------------------------------------------
# Vector & Prediction (reference: OPVector.scala; Prediction in Maps.scala)
# ---------------------------------------------------------------------------

class OPVector(FeatureType):
    """Dense feature vector; value is a tuple of floats (host form).

    On device this is a row of the assembled feature matrix; the wrapper
    exists for row-level (local scoring / test) use only.
    """

    @classmethod
    def _validate(cls, value):
        value = super()._validate(value)
        if value is None:
            return ()
        try:
            import numpy as np
            if isinstance(value, np.ndarray):
                return tuple(float(x) for x in value.tolist())
        except ImportError:  # pragma: no cover
            pass
        if isinstance(value, (list, tuple)):
            return tuple(float(x) for x in value)
        raise FeatureTypeError("OPVector requires a sequence of floats")

    @property
    def is_empty(self):
        return len(self._value) == 0


class SparseIndices(FeatureType):
    """Hashed sparse feature indices; value is a tuple of ints (host form).

    The Criteo-scale path: on device this is a row of the (n, K) int32
    hashed-index matrix consumed by the sparse model kernels via gathers /
    segment-sums — never materialized as a dense (n, buckets) block.
    Reference: OPCollectionHashingVectorizer.scala (shared hash space).
    """

    @classmethod
    def _validate(cls, value):
        value = super()._validate(value)
        if value is None:
            return ()
        try:
            import numpy as np
            if isinstance(value, np.ndarray):
                return tuple(int(x) for x in value.tolist())
        except ImportError:  # pragma: no cover
            pass
        if isinstance(value, (list, tuple)):
            return tuple(int(x) for x in value)
        raise FeatureTypeError("SparseIndices requires a sequence of ints")

    @property
    def is_empty(self):
        return len(self._value) == 0


class Prediction(OPMap):
    """Model output map: prediction, rawPrediction_*, probability_*.

    Reference: features/.../types/Maps.scala (Prediction) — keys follow the
    same naming so downstream evaluators/insights can be checked for parity.
    """
    value_type = float
    nullable = False

    @classmethod
    def _validate(cls, value):
        if value is None:
            raise FeatureTypeError("Prediction cannot be empty")
        value = super()._validate(value)
        if "prediction" not in value:
            raise FeatureTypeError("Prediction requires a 'prediction' key")
        return {str(k): float(v) for k, v in value.items()}

    @property
    def prediction(self) -> float:
        return self._value["prediction"]

    @property
    def raw_prediction(self) -> Tuple[float, ...]:
        return self._keys_prefixed("rawPrediction_")

    @property
    def probability(self) -> Tuple[float, ...]:
        return self._keys_prefixed("probability_")

    def _keys_prefixed(self, prefix):
        ks = sorted((k for k in self._value if k.startswith(prefix)),
                    key=lambda k: int(k[len(prefix):]))
        return tuple(self._value[k] for k in ks)

    @staticmethod
    def make(prediction: float, raw_prediction=(), probability=()) -> "Prediction":
        d = {"prediction": float(prediction)}
        d.update({f"rawPrediction_{i}": float(x) for i, x in enumerate(raw_prediction)})
        d.update({f"probability_{i}": float(x) for i, x in enumerate(probability)})
        return Prediction(d)


# ---------------------------------------------------------------------------
# Factory / registry (reference: FeatureTypeFactory.scala)
# ---------------------------------------------------------------------------

class FeatureTypeFactory:
    @staticmethod
    def by_name(name: str) -> Type[FeatureType]:
        try:
            return _REGISTRY[name]
        except KeyError:
            raise FeatureTypeError(f"unknown feature type: {name}") from None

    @staticmethod
    def all_types() -> Dict[str, Type[FeatureType]]:
        return dict(_REGISTRY)

    @staticmethod
    def is_subtype(a: Type[FeatureType], b: Type[FeatureType]) -> bool:
        return issubclass(a, b)


def _nullable_variant_check():
    # RealNN is the only non-nullable scalar; Prediction the only such map.
    assert not RealNN.nullable and not Prediction.nullable
