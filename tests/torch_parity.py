"""Fit one stage in both packages on the same data and compare.

:func:`fit_both` builds the same typed columns in the JAX package and in
the port, wires ``module.cls(**kw)`` to the named inputs in each, fits
(for an estimator) and transforms; :func:`assert_same_stage` then holds
the port to the JAX package BITWISE: the stage JSON (class key, params,
fitted state), the output column (values, type, manifest) and the row
path (``transform_value``) on every row. Host stages are copied code, so
nothing looser is allowed.
"""
from __future__ import annotations

import importlib
import json
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

PKGS = ("transmogrifai_tpu", "transmogrifai_tpu_torch")


def reset_uids():
    for pkg in PKGS:
        importlib.import_module(f"{pkg}.features.feature").reset_uids()


def build(pkg: str, columns: Dict[str, Tuple[str, Sequence[Any]]],
          response: Optional[str] = None):
    """(Dataset, {name: Feature}) of ``columns`` ({name: (type name,
    values)}) in package ``pkg``."""
    root = importlib.import_module(pkg)
    ft = root.features.types
    ds = root.Dataset.from_dict({n: list(v) for n, (_, v) in columns.items()},
                                {n: getattr(ft, t)
                                 for n, (t, _) in columns.items()})
    feats = {}
    for n, (t, _) in columns.items():
        b = root.FeatureBuilder.of(getattr(ft, t), n).from_column()
        feats[n] = b.as_response() if n == response else b.as_predictor()
    return ds, feats


def fit_one(pkg: str, module: str, cls: str, kw: Dict[str, Any],
            inputs: Sequence[str], columns, response=None, extra=None):
    """(fitted stage, transformed Dataset, input Dataset) in ``pkg``.
    ``extra``: attributes to set on the stage before fitting (the
    port's ``device``)."""
    reset_uids()
    ds, feats = build(pkg, columns, response)
    stage = getattr(importlib.import_module(f"{pkg}.{module}"), cls)(**kw)
    for k, v in (extra or {}).items():
        setattr(stage, k, v)
    stage.set_input(*[feats[n] for n in inputs])
    base = importlib.import_module(f"{pkg}.stages.base")
    model = stage.fit(ds) if isinstance(stage, base.Estimator) else stage
    return model, model.transform(ds), ds


def fit_both(module, cls, kw, inputs, columns, response=None,
             port_extra=None):
    j = fit_one(PKGS[0], module, cls, kw, inputs, columns, response)
    t = fit_one(PKGS[1], module, cls, kw, inputs, columns, response,
                port_extra)
    return j, t


def stage_doc(model) -> str:
    pkg = type(model).__module__.split(".")[0]
    persistence = importlib.import_module(f"{pkg}.stages.persistence")
    return json.dumps(persistence.stage_to_json(model), sort_keys=True,
                      default=repr)


def _same_cells(a, b) -> bool:
    if isinstance(a, np.ndarray) and a.dtype.kind in "fc":
        return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    if isinstance(a, float) and isinstance(b, float):
        return (a == b) or (np.isnan(a) and np.isnan(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same_cells(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_cells(a[k], b[k])
                                            for k in a)
    return type(a) is type(b) and a == b


def assert_same_column(jds, tds, name):
    assert tds.ftype(name).__name__ == jds.ftype(name).__name__
    jc, tc = jds.column(name), tds.column(name)
    if jc.dtype.kind in "fciub":
        assert tc.dtype == jc.dtype and tc.shape == jc.shape
        assert np.array_equal(tc, jc, equal_nan=jc.dtype.kind in "fc"), name
    else:
        assert _same_cells(tds.to_pylist(name), jds.to_pylist(name)), name
    jm, tm = jds.manifest(name), tds.manifest(name)
    assert (tm is None) == (jm is None)
    if jm is not None:
        assert tm.to_json() == jm.to_json()


def assert_same_stage(j, t, rows: bool = True):
    """``j``/``t``: :func:`fit_one` triples of the two packages."""
    (jm, jout, jds), (tm, tout, tds) = j, t
    assert stage_doc(tm) == stage_doc(jm)
    name = jm.output.name
    assert tm.output.name == name
    assert_same_column(jout, tout, name)
    if not rows:
        return
    names = jm.input_names
    for i in range(jds.n_rows):
        jv = jm.transform_value(*[jds.typed_value(n, i) for n in names])
        tv = tm.transform_value(*[tds.typed_value(n, i) for n in names])
        assert type(tv).__name__ == type(jv).__name__
        assert _same_cells(tv.value, jv.value), (i, tv, jv)


def jax_lam0(k, V, seed=0):
    """The JAX package's initial LDA lambda (``jax.random.gamma``, which
    torch cannot reproduce), to hand to the port's ``OpLDA`` /
    ``fit_lda`` as ``lam0``."""
    import jax
    return np.asarray(jax.random.gamma(jax.random.PRNGKey(seed), 100.0,
                                       (k, V)) * 0.01 + 1e-2, np.float32)
