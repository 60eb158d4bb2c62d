"""TestFeatureBuilder: (values...) -> (Dataset, Feature...).

Reference: testkit/.../test/TestFeatureBuilder.scala — builds a DataFrame
plus wired raw Features from in-memory sequences so stage tests need no
reader machinery.

The port's copy of ``transmogrifai_tpu/testkit/builders.py`` (host code; its imports
are relative, so it is the JAX package's text).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple, Type

from ..dataset import Dataset, column_to_numpy
from ..features import types as ft
from ..features.feature import Feature, FeatureBuilder
from .generators import RandomStream


class TestFeatureBuilder:
    @staticmethod
    def of(columns: Dict[str, Tuple[Type[ft.FeatureType], Sequence[Any]]],
           response: str = "") -> Tuple[Dataset, Dict[str, Feature]]:
        """Build (Dataset, {name: raw Feature}) from `{name: (type, values)}`.

        Values may also be a RandomStream (n inferred from the longest
        explicit column, default 20).
        """
        n = max((len(v) for _, v in columns.values()
                 if not isinstance(v, RandomStream)), default=20)
        cols, schema = {}, {}
        for name, (wtype, values) in columns.items():
            if isinstance(values, RandomStream):
                values = values.take(n)
            if len(values) != n:
                raise ValueError(
                    f"column {name!r} has {len(values)} values, expected {n}")
            cols[name] = column_to_numpy(values, wtype)
            schema[name] = wtype
        ds = Dataset(cols, schema)
        feats = {}
        for name, (wtype, _) in columns.items():
            fb = FeatureBuilder.of(wtype, name).from_column()
            feats[name] = (fb.as_response() if name == response
                           else fb.as_predictor())
        return ds, feats

    @staticmethod
    def single(name: str, wtype: Type[ft.FeatureType],
               values: Sequence[Any]) -> Tuple[Dataset, Feature]:
        ds, feats = TestFeatureBuilder.of({name: (wtype, list(values))})
        return ds, feats[name]

    @staticmethod
    def random(spec: Dict[str, RandomStream], n: int = 20,
               response: str = "") -> Tuple[Dataset, Dict[str, Feature]]:
        cols = {name: (s.wtype, s.take(n)) for name, s in spec.items()}
        return TestFeatureBuilder.of(cols, response=response)
