"""The port's ``stages/wrappers.py`` against the JAX package, and the JAX
package's ``tests/test_wrappers.py`` case for case on the port.

A wrapped sklearn-style object fits and transforms alike in both
packages (stage JSON with its pickled object, output column and rows
BITWISE), and a wrapped stage saved by either package loads and
transforms in the other (the class key stays in the JAX namespace).
"""
import numpy as np
import pytest

from torch_mirror import (load_mirror, mirror_cases, port_on_cpu,  # noqa
                          run_mirror_case)
from torch_parity import assert_same_stage


class Standardizer:
    """Toy unsupervised estimator (module level, so it pickles)."""

    def fit(self, X):
        self.mu_, self.sd_ = X.mean(axis=0), X.std(axis=0) + 1e-9
        return self

    def transform(self, X):
        return (X - self.mu_) / self.sd_


class Squarer:
    def transform(self, X):
        return X * X


class CentroidClassifier:
    def fit(self, X, y):
        self.c_ = {c: X[y == c].mean(axis=0) for c in np.unique(y)}
        return self

    def predict_proba(self, X):
        d = np.stack([np.linalg.norm(X - self.c_[c], axis=1)
                      for c in sorted(self.c_)], axis=1)
        inv = 1.0 / (d + 1e-9)
        return inv / inv.sum(axis=1, keepdims=True)


class MeanRegressor:
    def fit(self, X, y):
        self.w_ = np.linalg.lstsq(X, y, rcond=None)[0]
        return self

    def predict(self, X):
        return X @ self.w_


def _wrapped(pkg, cls, obj, cols, inputs, response=None):
    import importlib
    from torch_parity import build, reset_uids
    W = importlib.import_module(f"{pkg}.stages.wrappers")
    base = importlib.import_module(f"{pkg}.stages.base")
    reset_uids()
    ds, feats = build(pkg, cols, response)
    st = getattr(W, cls)(obj()).set_input(*[feats[n] for n in inputs])
    model = st.fit(ds) if isinstance(st, base.Estimator) else st
    return model, model.transform(ds), ds


CASES = [("EstimatorWrapper", Standardizer, ["v"], None),
         ("TransformerWrapper", Squarer, ["v"], None),
         ("PredictorWrapper", CentroidClassifier, ["y", "v"], "y"),
         ("PredictorWrapper", MeanRegressor, ["y", "v"], "y")]


def _cols(obj):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(80, 3))
    y = (X[:, 0] + 0.2 * rng.normal(size=80) > 0).astype(float)
    if obj is MeanRegressor:
        y = X @ np.array([1.0, -2.0, 0.5]) + 0.1 * rng.normal(size=80)
    return {"y": ("RealNN", [float(v) for v in y]),
            "v": ("OPVector", [tuple(float(x) for x in r) for r in X])}


@pytest.mark.parametrize("cls,obj,inputs,response", CASES,
                         ids=[f"{c}-{o.__name__}" for c, o, *_r in CASES])
def test_wrapper_bitwise_parity_with_jax(cls, obj, inputs, response):
    cols = _cols(obj)
    j = _wrapped("transmogrifai_tpu", cls, obj, cols, inputs, response)
    t = _wrapped("transmogrifai_tpu_torch", cls, obj, cols, inputs,
                 response)
    assert_same_stage(j, t)


@pytest.mark.parametrize("cls,obj,inputs,response", CASES,
                         ids=[f"{c}-{o.__name__}" for c, o, *_r in CASES])
def test_wrapped_stage_loads_across_packages(cls, obj, inputs, response):
    from transmogrifai_tpu.stages import persistence as JP
    from transmogrifai_tpu_torch.stages import persistence as PP
    cols = _cols(obj)
    j = _wrapped("transmogrifai_tpu", cls, obj, cols, inputs, response)
    t = _wrapped("transmogrifai_tpu_torch", cls, obj, cols, inputs,
                 response)
    for (src, out, _), (_m, _o, dst_ds), saver, loader in (
            (j, t, JP, PP), (t, j, PP, JP)):
        loaded = loader.stage_from_json(saver.stage_to_json(src))
        got = loaded.transform(dst_ds)
        assert got.to_pylist(loaded.output.name) == out.to_pylist(
            src.output.name)


def test_stages_package_exports_the_wrappers():
    """As the JAX ``stages/__init__.py`` does: the four wrapper classes
    import from ``stages``, and importing the package alone (a fresh
    interpreter) registers their bare names."""
    import subprocess
    import sys
    from transmogrifai_tpu import stages as J
    from transmogrifai_tpu_torch import stages as T
    names = ("EstimatorWrapper", "PredictorWrapper", "TransformerWrapper",
             "WrappedModel")
    for name in names:
        assert getattr(T, name).__name__ == getattr(J, name).__name__
        assert name in T.__all__
    code = ("import transmogrifai_tpu_torch.stages as S; "
            f"print(all(n in S.STAGE_REGISTRY for n in {names!r}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.stdout.strip() == "True", out.stderr[-500:]


MIRROR = load_mirror("test_wrappers.py")


@pytest.mark.parametrize("name,kwargs", mirror_cases(MIRROR))
def test_wrappers_case_on_the_port(name, kwargs, request, port_on_cpu):
    run_mirror_case(MIRROR, name, kwargs, request)
