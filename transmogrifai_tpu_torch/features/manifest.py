"""Column-level provenance for assembled feature vectors (the port's copy of
``transmogrifai_tpu/features/manifest.py``).

Reference: utils/src/main/scala/com/salesforce/op/utils/spark/
OpVectorMetadata.scala (OpVectorMetadata, OpVectorColumnMetadata). The
reference rides provenance on Spark ML column Metadata; here it is a
first-class ColumnManifest attached to OPVector columns of a Dataset.
Every slot of the device feature matrix knows: which raw feature produced
it, the feature's type, its grouping (categorical group / map key), and
what the slot indicates (a one-hot value, a null-indicator, an imputed
numeric, a hash bucket, ...). ModelInsights and LOCO are built on this.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

HASH_DESCRIPTOR_PREFIX = "hash_"
NULL_INDICATOR = "NullIndicatorValue"
OTHER_INDICATOR = "OTHER"


@dataclass(frozen=True)
class ColumnMeta:
    """Provenance of one slot in a feature vector."""
    parent_feature: str                       # name of the parent feature
    parent_type: str                          # FeatureType class name
    grouping: Optional[str] = None            # categorical group / map key
    indicator_value: Optional[str] = None     # one-hot value or NULL_INDICATOR
    descriptor_value: Optional[str] = None    # e.g. "imputed", "sin", "x"
    index: int = 0

    @property
    def is_null_indicator(self) -> bool:
        return self.indicator_value == NULL_INDICATOR

    @property
    def is_hashed(self) -> bool:
        """True for hashing-trick slots. The ONE definition the hashing
        vectorizers (ops/vectorizers.py, ops/maps.py) and the
        SanityChecker's correlation_exclusion='hashed_text' share —
        keyed on HASH_DESCRIPTOR_PREFIX so the contract lives here, not
        as a string spread across modules."""
        return (self.descriptor_value or "").startswith(
            HASH_DESCRIPTOR_PREFIX)

    @property
    def is_indicator(self) -> bool:
        return self.indicator_value is not None

    def column_name(self) -> str:
        bits = [self.parent_feature]
        if self.grouping and self.grouping != self.parent_feature:
            bits.append(self.grouping)
        if self.indicator_value is not None:
            bits.append(str(self.indicator_value))
        elif self.descriptor_value is not None:
            bits.append(str(self.descriptor_value))
        return "_".join(bits)

    def feature_group(self) -> str:
        """LOCO grouping key: all slots of one raw feature (sub)group move
        together when leave-one-out deltas are computed."""
        return f"{self.parent_feature}|{self.grouping or ''}"

    def to_json(self) -> Dict[str, Any]:
        return {
            "parentFeature": self.parent_feature,
            "parentType": self.parent_type,
            "grouping": self.grouping,
            "indicatorValue": self.indicator_value,
            "descriptorValue": self.descriptor_value,
            "index": self.index,
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ColumnMeta":
        return ColumnMeta(d["parentFeature"], d["parentType"], d.get("grouping"),
                          d.get("indicatorValue"), d.get("descriptorValue"),
                          d.get("index", 0))


class ColumnManifest:
    """Ordered provenance for every column of an OPVector feature."""

    __slots__ = ("columns",)

    def __init__(self, columns: Sequence[ColumnMeta]):
        self.columns = tuple(replace(c, index=i) for i, c in enumerate(columns))

    def __len__(self) -> int:
        return len(self.columns)

    def __iter__(self):
        return iter(self.columns)

    def __getitem__(self, i: int) -> ColumnMeta:
        return self.columns[i]

    def __eq__(self, other):
        return isinstance(other, ColumnManifest) and self.columns == other.columns

    @property
    def size(self) -> int:
        return len(self.columns)

    def column_names(self) -> List[str]:
        return [c.column_name() for c in self.columns]

    @staticmethod
    def concat(manifests: Sequence["ColumnManifest"]) -> "ColumnManifest":
        cols: List[ColumnMeta] = []
        for m in manifests:
            cols.extend(m.columns)
        return ColumnManifest(cols)

    @staticmethod
    def real(parent: str, ptype: str, descriptor: str = "value") -> "ColumnManifest":
        return ColumnManifest([ColumnMeta(parent, ptype, descriptor_value=descriptor)])

    def select(self, keep: Sequence[int]) -> "ColumnManifest":
        return ColumnManifest([self.columns[i] for i in keep])

    # -- grouping views (used by LOCO / SanityChecker / ModelInsights) ---
    def groups(self) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {}
        for c in self.columns:
            out.setdefault(c.feature_group(), []).append(c.index)
        return out

    def by_parent(self) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {}
        for c in self.columns:
            out.setdefault(c.parent_feature, []).append(c.index)
        return out

    def indicator_groups(self) -> Dict[str, List[int]]:
        """Groups of mutually-exclusive one-hot slots (for Cramér's V)."""
        out: Dict[str, List[int]] = {}
        for c in self.columns:
            if c.is_indicator:
                out.setdefault(c.feature_group(), []).append(c.index)
        return out

    def to_json(self) -> List[Dict[str, Any]]:
        return [c.to_json() for c in self.columns]

    @staticmethod
    def from_json(cols: List[Dict[str, Any]]) -> "ColumnManifest":
        return ColumnManifest([ColumnMeta.from_json(c) for c in cols])

    def __repr__(self):
        return f"ColumnManifest({len(self.columns)} cols)"
