"""Test kit: seeded data generators, feature/dataset builders, base specs.

Reference: testkit/src/main/scala/com/salesforce/op/testkit/
(Random{Real,Integral,Binary,Text,List,Set,Map,Vector}.scala) and
com.salesforce.op.test (TestFeatureBuilder.scala, OpTransformerSpec,
OpEstimatorSpec). Generators are deterministic seeded streams per feature
type with configurable missing-value probability; `TestFeatureBuilder`
turns in-memory sequences into (Dataset, Feature...) pairs; the spec base
classes give every stage contract tests (expected output, JSON round-trip
through persistence, row-fn/batch parity) for free.

The "local Spark" equivalent is CPU JAX with a forced 8-device host
platform — tests/conftest.py sets that up (SURVEY.md §4).

The port's copy of ``transmogrifai_tpu/testkit/__init__.py`` (host code; its imports
are relative, so it is the JAX package's text).
"""
from .generators import (RandomBinary, RandomGeolocation, RandomIntegral,
                         RandomList, RandomMap, RandomMultiPickList,
                         RandomReal, RandomText, RandomVector)
from .builders import TestFeatureBuilder
from .specs import EstimatorSpec, TransformerSpec

__all__ = [
    "RandomReal", "RandomIntegral", "RandomBinary", "RandomText",
    "RandomList", "RandomMultiPickList", "RandomMap", "RandomVector",
    "RandomGeolocation", "TestFeatureBuilder", "TransformerSpec",
    "EstimatorSpec",
]
