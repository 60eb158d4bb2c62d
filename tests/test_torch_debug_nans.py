"""The port's NaN debugging (``profiling.debug_nans``) against the JAX
package's ``jax_debug_nans`` on the same inputs: it must raise, or not,
exactly where the JAX package does. The inputs: clean data, a column
with missing values (both fit through transmogrify and an LR + GBT
selector, and complete in both packages: a NaN carried in from the data
is not an op's), a 0/0 planted in a computation (both raise, naming the
division), and a SanityChecker over a constant column (both raise: its
correlation for a zero-variance column is a deliberate NaN). Also: the
prior state returns on exit (``test_hardening.py``'s case), the checks
hold in the threads a run fits on, and the hand-written kernels' wrapper
check.
"""
import importlib
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.profiling import debug_nans as jax_debug_nans
from transmogrifai_tpu_torch import parallel as TP
from transmogrifai_tpu_torch import profiling
from transmogrifai_tpu_torch.parallel import spmd

PKGS = ("transmogrifai_tpu", "transmogrifai_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(pkg, kind):
    root = importlib.import_module(pkg)
    ft = root.features.types
    rng = np.random.default_rng(0)
    n = 240
    a, b = rng.normal(size=n), rng.normal(size=n)
    y = (a + b > 0).astype(float)
    a = a.tolist()
    if kind == "missing":
        for i in range(0, n, 7):
            a[i] = None
    return root.Dataset.from_dict(
        {"a": a, "b": b.tolist(), "y": y.tolist()},
        {"a": ft.Real, "b": ft.Real, "y": ft.RealNN})


def _train(pkg, kind, checker=False):
    """transmogrify (+ SanityChecker) -> LR + GBT selector, in ``pkg``."""
    for m in ("models", "ops.transmogrifier", "ops.sanity_checker",
              "workflow", "features.feature"):
        importlib.import_module(f"{pkg}.{m}")
    root = importlib.import_module(pkg)
    root.features.feature.reset_uids()
    ft, FB = root.features.types, root.FeatureBuilder
    ds = _dataset(pkg, kind)
    y = FB.of(ft.RealNN, "y").from_column().as_response()
    vec = root.ops.transmogrifier.transmogrify(
        [FB.of(ft.Real, c).from_column().as_predictor() for c in "ab"])
    if checker:
        vec = root.ops.sanity_checker.SanityChecker().set_input(y, vec).output
    sel = root.models.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=2, candidates=[
            ["LogisticRegression", {"regParam": [0.1],
                                    "elasticNetParam": [0.0]}],
            ["GBTClassifier", {"maxDepth": [2.0], "maxIter": [3.0]}]])
    pred = sel.set_input(y, vec).output
    wf = root.workflow.Workflow([pred])
    kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
    return wf.train(ds, **kw)


def _planted(pkg):
    if pkg.endswith("_torch"):
        z = torch.zeros(3)
        return z / z
    z = jnp.zeros(3)
    return (z / z).block_until_ready()


def _outcome(pkg, case):
    debug = (profiling.debug_nans if pkg.endswith("_torch")
             else jax_debug_nans)
    if not pkg.endswith("_torch"):
        # JAX decides whether a compiled program checks its outputs when
        # it compiles it: a program another test compiled earlier in
        # this process would skip the check
        jax.clear_caches()
    try:
        with debug(True):
            if case == "planted":
                _planted(pkg)
            else:
                _train(pkg, case, checker=case == "checker")
    except FloatingPointError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case,raises", [("clean", False),
                                         ("missing", False),
                                         ("planted", True),
                                         ("checker", True)])
def test_raise_parity_with_jax(case, raises):
    got = {pkg: _outcome(pkg, case) for pkg in PKGS}
    assert (got[PKGS[0]] is not None) == raises, got
    assert (got[PKGS[1]] is not None) == raises, got
    if case == "planted":
        assert "div" in got[PKGS[0]] and "div" in got[PKGS[1]]
    if case == "checker":
        # the JAX package raises converting its NaN constant; the port
        # where it makes it
        assert "full_like" in got[PKGS[1]]


def test_debug_nans_restores_setting():
    prev = profiling.nan_checking()
    with profiling.debug_nans(True):
        assert profiling.nan_checking() is True
        with profiling.debug_nans(False):
            assert profiling.nan_checking() is True
    assert profiling.nan_checking() == prev is False
    with pytest.raises(FloatingPointError):
        with profiling.debug_nans():
            torch.zeros(1) / torch.zeros(1)
    assert profiling.nan_checking() is False
    torch.zeros(1) / torch.zeros(1)                 # unchecked again
    prevj = jax.config.jax_debug_nans
    with jax_debug_nans(True):
        assert jax.config.jax_debug_nans is True
    assert jax.config.jax_debug_nans == prevj


def test_carried_nans_are_not_an_ops():
    """A NaN already in an input (a missing value moved or masked) does
    not raise; one an op makes from clean inputs does."""
    x = torch.tensor([1.0, float("nan"), 3.0])
    with profiling.debug_nans():
        y = x * 2.0 + 1.0
        torch.where(torch.isnan(y), 0.0, y).sum()
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.tensor([-1.0]))


def test_checks_hold_in_rank_and_worker_threads():
    mesh = TP.data_mesh(["cpu"] * 2)

    def fn(r):
        z = torch.zeros(2)
        return z / z if r == 1 else z

    spmd.run_ranks(mesh, fn, 4)                     # unchecked: no raise
    with profiling.debug_nans():
        with pytest.raises(FloatingPointError, match="div"):
            spmd.run_ranks(mesh, fn, 4)
        box = {}

        def worker():
            try:
                with profiling.nan_checks():
                    torch.zeros(1) / torch.zeros(1)
            except FloatingPointError as e:
                box["e"] = e
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        assert "e" in box


def test_kernel_wrapper_check():
    """The check the ctypes-launched kernels make on their outputs."""
    clean, nan = torch.ones(3), torch.tensor([0.0, float("nan")])
    profiling.check_nan_outputs("tree_histogram", [clean], [clean])
    profiling.check_nan_outputs("ring_allreduce", [nan], [nan])
    with pytest.raises(FloatingPointError,
                       match="encountered in ring_allreduce"):
        profiling.check_nan_outputs("ring_allreduce", [clean, nan], [clean])
