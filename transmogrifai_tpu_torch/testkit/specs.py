"""Base contract specs for stages.

Reference: testkit's OpTransformerSpec / OpEstimatorSpec — every stage
test inheriting these gets for free: expected-output check, JSON
persistence round-trip, uid/copy semantics, and row-fn/batch parity
(the reference additionally checks Spark metadata; here the manifest
travels with the Dataset column and is covered by vectorizer tests).

Usage (pytest): subclass, define `make_stage()` returning a WIRED stage
(set_input already called), `dataset()` returning the input Dataset, and
optionally `expected()` returning the expected output column as a list.

The port's copy of ``transmogrifai_tpu/testkit/specs.py`` (host code; its imports
are relative, so it is the JAX package's text).
"""
from __future__ import annotations

import json
from typing import Any, List, Optional

import numpy as np

from ..dataset import Dataset
from ..stages.base import Estimator, Transformer
from ..stages.persistence import stage_from_json, stage_to_json


def _values_equal(a: Any, b: Any, tol: float = 1e-6) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(
            _values_equal(x, y, tol) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(
            _values_equal(a[k], b[k], tol) for k in a)
    if isinstance(a, float) or isinstance(b, float):
        try:
            fa, fb = float(a), float(b)
        except (TypeError, ValueError):
            return a == b
        if np.isnan(fa) and np.isnan(fb):
            return True
        return abs(fa - fb) <= tol * max(1.0, abs(fa), abs(fb))
    return a == b


class _SpecCommon:
    tol = 1e-6

    def make_stage(self):
        raise NotImplementedError

    def dataset(self) -> Dataset:
        raise NotImplementedError

    def expected(self) -> Optional[List[Any]]:
        return None

    # -- helpers ----------------------------------------------------------
    def _fitted(self) -> Transformer:
        st = self.make_stage()
        if isinstance(st, Estimator):
            return st.fit(self.dataset())
        return st

    def assert_column_equal(self, ds: Dataset, name: str,
                            expected: List[Any]) -> None:
        got = ds.to_pylist(name)
        assert len(got) == len(expected), (len(got), len(expected))
        for i, (g, e) in enumerate(zip(got, expected)):
            assert _values_equal(g, e, self.tol), (
                f"row {i}: got {g!r}, expected {e!r}")

    # -- contract tests (collected by pytest on subclasses) ---------------
    def test_transform_output(self):
        model = self._fitted()
        ds = model.transform(self.dataset())
        out = model.output.name
        assert out in ds, f"output column {out} missing"
        assert ds.ftype(out) is model.output.wtype
        exp = self.expected()
        if exp is not None:
            self.assert_column_equal(ds, out, exp)

    def test_uid_uniqueness_and_copy(self):
        a, b = self.make_stage(), self.make_stage()
        assert a.uid != b.uid, "two instances must get distinct uids"
        assert a.output.name != b.output.name or a.output.uid != b.output.uid

    def test_json_roundtrip(self):
        model = self._fitted()
        doc = json.loads(json.dumps(stage_to_json(model)))
        restored = stage_from_json(doc)
        assert restored.uid == model.uid
        assert restored.input_names == model.input_names
        assert restored.output.name == model.output.name
        ds1 = model.transform(self.dataset())
        ds2 = restored.transform(self.dataset())
        out = model.output.name
        self.assert_column_equal(ds2, out, ds1.to_pylist(out))

    def test_row_fn_matches_batch(self):
        model = self._fitted()
        try:
            fn = model.make_row_fn()
        except NotImplementedError:
            return  # batch-only stage: no row path to compare
        ds = model.transform(self.dataset())
        out = model.output.name
        rows = list(self.dataset().rows())
        for i in (0, ds.n_rows - 1):
            try:
                got = fn(rows[i])
            except NotImplementedError:
                return
            batch = ds.raw_value(out, i)
            assert _values_equal(got, batch, self.tol), (
                f"row {i}: row_fn {got!r} != batch {batch!r}")


class TransformerSpec(_SpecCommon):
    """Contract spec for Transformer stages."""


class EstimatorSpec(_SpecCommon):
    """Contract spec for Estimator stages (adds fit determinism)."""

    def test_fit_deterministic(self):
        st1, st2 = self.make_stage(), self.make_stage()
        assert isinstance(st1, Estimator), "EstimatorSpec needs an Estimator"
        m1 = st1.fit(self.dataset())
        m2 = st2.fit(self.dataset())
        ds1 = m1.transform(self.dataset())
        ds2 = m2.transform(self.dataset())
        self.assert_column_equal(ds2, m2.output.name,
                                 ds1.to_pylist(m1.output.name))
