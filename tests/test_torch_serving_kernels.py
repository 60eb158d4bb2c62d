"""The port's fused serving kernel module against the JAX package's.

On the CPU the wrapper ``fused_linear_scores`` is its plain version
``fused_linear_scores_torch``; both are held against the JAX package's
XLA twin ``fused_linear_scores_xla`` (the same formulation, f32
operands on the CPU: rtol = atol = 1e-5, summation order may differ)
and its f64 numpy oracle ``np_reference_scores`` (atol 1e-4). The
interpret-mode Pallas kernel is not used as the reference: it does not
run under the installed jax. The CUDA kernel itself runs only on the
card: tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import serving_kernels as jsk
from transmogrifai_tpu_torch.models import serving_kernels as tsk


def _inputs(seed, n, p, K, L):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    W = (0.5 * rng.normal(size=(K, p + 1, L))).astype(np.float32)
    mid = rng.integers(0, K, size=n).astype(np.int32)
    return X, W, mid


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("K", [1, 2, 5])
@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("p", [5, 24])
@pytest.mark.parametrize("n", [37, 64])
def test_plain_matches_xla_twin_and_oracle(monkeypatch, K, L, p, n):
    monkeypatch.delenv("TM_KERNEL_EXACT", raising=False)
    X, W, mid = _inputs(K * 100 + L * 10 + p + n, n, p, K, L)
    got = tsk.fused_linear_scores_torch(*_t(X, W, mid)).numpy()
    xla = np.asarray(jsk.fused_linear_scores_xla(X, W, mid))
    assert got.shape == xla.shape == (n, L)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jsk.np_reference_scores(X, W, mid),
                               atol=1e-4)
    # the wrapper on a CPU tensor IS the plain version, and launches
    # nothing
    before = tsk.fused_linear_scores.launches
    wrapped = tsk.fused_linear_scores(*_t(X, W, mid)).numpy()
    np.testing.assert_array_equal(wrapped, got)
    assert tsk.fused_linear_scores.launches == before


def test_bf16_operand_mode_rounds_operands_only():
    """bf16 operands (the CUDA serve dtype), f32 accumulation, the
    intercept added unrounded: equals the f64 oracle on bf16-rounded X
    and weight rows."""
    X, W, mid = _inputs(7, 53, 24, 4, 3)
    got = tsk.fused_linear_scores_torch(*_t(X, W, mid),
                                        dtype=torch.bfloat16).numpy()
    Xr = torch.from_numpy(X).to(torch.bfloat16).float().numpy()
    Wr = W.copy()
    Wr[:, :-1] = torch.from_numpy(W[:, :-1]).to(
        torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, jsk.np_reference_scores(Xr, Wr, mid),
                               atol=1e-4)
    assert np.abs(got - jsk.np_reference_scores(X, W, mid)).max() > 1e-4


def test_inf_in_unselected_model_stays_finite():
    X, W, mid = _inputs(3, 40, 24, 4, 1)
    mid = mid % 3                       # no row selects model 3
    W[3] = np.inf
    got = tsk.fused_linear_scores_torch(*_t(X, W, mid)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, np.asarray(jsk.fused_linear_scores_xla(X, W, mid)),
        rtol=1e-5, atol=1e-5)


def test_out_of_range_model_id_scores_zero_like_the_twin():
    X, W, mid = _inputs(5, 16, 5, 3, 2)
    mid[::4] = 3                        # == K: the all-false mask row
    got = tsk.fused_linear_scores_torch(*_t(X, W, mid)).numpy()
    np.testing.assert_array_equal(got[::4], 0.0)
    np.testing.assert_allclose(
        got, np.asarray(jsk.fused_linear_scores_xla(X, W, mid)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fn", ["fused_linear_scores",
                                "fused_linear_scores_torch"])
def test_wrong_weight_rows_raise(fn):
    X, W, mid = _inputs(1, 8, 5, 2, 1)
    with pytest.raises(ValueError, match="weight stack rows 5 != "
                                         "features\\+intercept 6"):
        getattr(tsk, fn)(*_t(X, W[:, :-1], mid))
    with pytest.raises(ValueError, match="weight stack rows"):
        jsk.fused_linear_scores(X, W[:, :-1], mid, interpret=True)
    with pytest.raises(TypeError, match="int32"):
        getattr(tsk, fn)(*_t(X, W, mid.astype(np.int64)))
    with pytest.raises(TypeError, match="float32"):
        getattr(tsk, fn)(*_t(X.astype(np.float64), W, mid))
    with pytest.raises(ValueError, match="mid has"):
        getattr(tsk, fn)(*_t(X, W, mid[:-1]))


@pytest.mark.parametrize("n,p,K,L", [(64, 24, 4, 1), (37, 24, 4, 1),
                                     (32768, 24, 100, 1), (4096, 24, 8, 3),
                                     (1, 1, 1, 1)])
def test_cost_floor_and_oracle_match_jax(n, p, K, L):
    assert tsk.fused_cost_floor(n, p, K, L) == jsk.fused_cost_floor(
        n, p, K, L)
    X, W, mid = _inputs(n + p, min(n, 50), p, K, L)
    np.testing.assert_array_equal(tsk.np_reference_scores(X, W, mid),
                                  jsk.np_reference_scores(X, W, mid))


def test_serve_dtype_policy(monkeypatch):
    monkeypatch.delenv("TM_KERNEL_EXACT", raising=False)
    assert tsk.serve_dtype("cpu") == torch.float32
    assert tsk.serve_dtype(torch.device("cuda")) == torch.bfloat16
    assert tsk.serve_policy_token("cpu") != tsk.serve_policy_token("cuda")
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    assert tsk.kernel_exact()
    assert tsk.serve_dtype("cuda") == torch.float32
    assert tsk.serve_policy_token("cuda") == (True, "torch.float32", "cuda")
