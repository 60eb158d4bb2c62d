"""Raw-feature generation stage (the port's copy of
``transmogrifai_tpu/stages/generator.py``; host-only, unchanged).

Reference: core/src/main/scala/com/salesforce/op/stages/
FeatureGeneratorStage.scala — the origin stage of every raw feature. Holds
the user's extract function (raw record -> value) and an optional
event-time aggregator name (resolved by the aggregate readers).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Type

import numpy as np

from ..dataset import Dataset, column_to_numpy
from ..features import types as ft
from ..features.feature import Feature, TransientFeature, make_uid
from .base import PipelineStage


class FeatureGeneratorStage(PipelineStage):
    operation_name = "raw"

    def __init__(self, name: str, wtype: Type[ft.FeatureType],
                 extract_fn: Callable[[Any], Any],
                 aggregator: Optional[str] = None,
                 is_response: bool = False,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.feature_name = name
        self.wtype = wtype
        self.extract_fn = extract_fn
        self.aggregator = aggregator
        self.is_response = is_response
        self._output = Feature(name=name, wtype=wtype, origin_stage=self,
                               parents=(), is_response=is_response)
        self.inputs = ()

    def extract(self, record: Any) -> Any:
        v = self.extract_fn(record)
        return v.value if isinstance(v, ft.FeatureType) else v

    def generate_column(self, records: Sequence[Any]) -> np.ndarray:
        return column_to_numpy([self.extract(r) for r in records], self.wtype)

    def stage_params_json(self) -> Dict[str, Any]:
        return {"featureName": self.feature_name, "type": self.wtype.__name__,
                "aggregator": self.aggregator, "isResponse": self.is_response}

    @classmethod
    def from_params_json(cls, uid: str, params: Dict[str, Any]) -> "FeatureGeneratorStage":
        """Reconstruct with a column-lookup extract fn (custom python extract
        closures are not persistable; reloaded models read prepared columns)."""
        from ..features.feature import column_extract
        name = params["featureName"]
        return cls(name=name,
                   wtype=ft.FeatureTypeFactory.by_name(params["type"]),
                   extract_fn=column_extract(name),
                   aggregator=params.get("aggregator"),
                   is_response=params.get("isResponse", False),
                   uid=uid)


def materialize_raw(records: Sequence[Any], features: Sequence[Feature]) -> Dataset:
    """Apply each raw feature's extract fn over records -> columnar Dataset.

    Mirrors the reference's reader.generateDataFrame(rawFeatures)
    (readers/DataReader.scala) minus the aggregation path, which the
    aggregate readers handle before this point.
    """
    cols: Dict[str, np.ndarray] = {}
    schema: Dict[str, Type[ft.FeatureType]] = {}
    for f in features:
        stage = f.origin_stage
        if not isinstance(stage, FeatureGeneratorStage):
            raise ValueError(f"{f.name} is not a raw feature")
        cols[f.name] = stage.generate_column(records)
        schema[f.name] = f.wtype
    return Dataset(cols, schema)


def raw_dataset_for(ds_or_records, features: Sequence[Feature]) -> Dataset:
    """Accept a reader, a prepared Dataset (column check only), or records."""
    from ..resilience.faults import fault_point
    fault_point("readers.read", features=len(features))
    if hasattr(ds_or_records, "generate_dataset") and not isinstance(
            ds_or_records, Dataset):
        return ds_or_records.generate_dataset(features)
    if isinstance(ds_or_records, Dataset):
        missing = [f.name for f in features if f.name not in ds_or_records]
        if not missing:
            return ds_or_records.select([f.name for f in features])
        # fall through: treat rows as records for extract fns
        return materialize_raw(list(ds_or_records.rows()), features)
    return materialize_raw(list(ds_or_records), features)
