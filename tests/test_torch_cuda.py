"""The port's CUDA kernels on the card, each against its plain PyTorch
version. Every test here is ``cuda``-marked and skips without a card.

The file imports neither JAX nor the JAX package, so it runs on a GPU
machine that has no JAX; ``tests/conftest.py`` imports JAX, hence
``--noconftest`` there:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.models import serving_kernels as sk


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,K,L", [(64, 22, 4, 1), (37, 24, 4, 1),
                                     (4096, 24, 8, 3), (1, 1, 1, 1),
                                     (300, 70, 200, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_linear_scores_kernel_matches_plain(card, n, p, K, L, dtype):
    """Ragged n, one model, a softmax head, and a weight block too big
    for shared memory (200 x 71 x 1 f32 > 48 KB); the last model holds
    inf and no row selects it. f32 accumulation in another order than
    the plain version's GEMM: rtol = atol = 1e-4."""
    rng = np.random.default_rng(n + p + K + L)
    X = rng.normal(size=(n, p)).astype(np.float32)
    W = (0.5 * rng.normal(size=(K, p + 1, L))).astype(np.float32)
    mid = rng.integers(0, max(K - 1, 1), size=n).astype(np.int32)
    if K > 1:
        W[K - 1] = np.inf
    Xt, Wt, mt = (torch.from_numpy(a).to(card) for a in (X, W, mid))
    before = sk.fused_linear_scores.launches
    got = sk.fused_linear_scores(Xt, Wt, mt, dtype=dtype)
    torch.cuda.synchronize()
    assert sk.fused_linear_scores.launches == before + 1
    ref = sk.fused_linear_scores_torch(Xt, Wt, mt, dtype=dtype)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_exact_mode_fused_group_still_launches_the_kernel(card,
                                                          monkeypatch):
    """TM_KERNEL_EXACT=1 on the card keeps the fused plane on the CUDA
    kernel, with f32 operands: one launch per bucket slice, and every
    row within 1e-5 of its own model's per-model score (f32
    accumulation in another order)."""
    import chip_smoke
    from transmogrifai_tpu_torch import portable
    from transmogrifai_tpu_torch.serving import ModelRegistry
    from transmogrifai_tpu_torch.serving.fusion import (FusedGroupScorer,
                                                        stack_spec_of)
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    rng = np.random.default_rng(7)
    reg = ModelRegistry()
    members, names = [], []
    for k in range(3):
        manifest, arrays, _par = chip_smoke.make_model_ir(rng, f"out{k}")
        reg.register(f"m{k}", portable.from_portable(manifest, arrays, card),
                     buckets=chip_smoke.BUCKETS)
        with reg.acquire(f"m{k}") as (_vname, backend):
            members.append((backend, stack_spec_of(backend)))
        names.append(f"out{k}")
    n = 40
    cols = {f"x{i}": np.where(rng.random(n) < 0.05, np.nan,
                              rng.normal(size=n))
            for i in range(chip_smoke.N_COLUMNS)}
    mid = rng.integers(0, 3, size=n).astype(np.int32)
    _n, vals = members[0][0].prepare(cols)
    scorer = FusedGroupScorer(members)
    assert scorer.exact
    before = sk.fused_linear_scores.launches
    got = scorer.finalize(scorer.launch(n, vals, mid))
    assert sk.fused_linear_scores.launches == before + 1   # one bucket slice
    for k, (backend, _spec) in enumerate(members):
        own = backend.scorer.score_arrays(cols)[names[k]]
        np.testing.assert_allclose(got[mid == k], own[mid == k], atol=1e-5)


@pytest.mark.cuda
def test_fused_linear_scores_kernel_rejects_bad_input(card):
    X = torch.zeros((8, 4), device=card)
    W = torch.zeros((2, 5, 1), device=card)
    mid = torch.zeros((8,), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        sk.fused_linear_scores(X.t().contiguous().t(), W, mid)
    with pytest.raises(ValueError, match="different devices"):
        sk.fused_linear_scores(X, W.cpu(), mid)
    with pytest.raises(TypeError, match="not supported"):
        sk.fused_linear_scores(X, W, mid, dtype=torch.float16)
