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


# ---------------------------------------------------------------------------
# tree_histogram
# ---------------------------------------------------------------------------

from transmogrifai_tpu_torch.models import kernels as tk   # noqa: E402

HIST_SHAPES = [  # G, n, d, S, m, B
    (16, 20_000, 28, 5, 8, 32),     # the capture shape, rows cut
    (12, 9_001, 28, 3, 16, 32),     # a GBT level, ragged n
    (6, 5_000, 28, 3, 32, 32),      # XGBoost's last level
    (192, 3_000, 28, 5, 16, 32),    # an RF level
    (1, 37, 5, 3, 1, 8),            # one instance, one node
]


def _hist_inputs(card, shape, integer, seed=0):
    G, n, d, S, m, B = shape
    rng = np.random.default_rng(seed + n)
    bins = rng.integers(0, B, size=(n, d)).astype(np.int32)
    stats = (rng.integers(-3, 4, size=(G, n, S)) if integer
             else rng.normal(size=(G, n, S))).astype(np.float32)
    pos = rng.integers(0, m, size=(G, n)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(card) for a in (bins, stats, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HIST_SHAPES)
def test_tree_histogram_exact_mode_is_bitwise_on_integer_stats(
        card, shape, monkeypatch):
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    bins, stats, pos = _hist_inputs(card, shape, integer=True)
    m, B = shape[4], shape[5]
    before = tk.histogram_grid.launches
    got = tk.histogram_grid(bins, stats, pos, m, B)
    torch.cuda.synchronize()
    assert tk.histogram_grid.launches == before + 1
    ref = tk.histogram_torch(bins, stats, pos, m, B)
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HIST_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tree_histogram_matches_plain_on_float_stats(card, shape, dtype,
                                                     monkeypatch):
    """f32 sums in another order than the plain version's GEMM (a
    sequential sum over each block's rows, then over <= 32 block
    partials): each cell within 1e-4 of the sum of its |terms|. The
    operand dtype comes from the knobs, as on the training path."""
    monkeypatch.setenv("TM_KERNEL_EXACT", "0")
    monkeypatch.setenv("TM_HIST_BF16",
                       "1" if dtype == torch.bfloat16 else "0")
    bins, stats, pos = _hist_inputs(card, shape, integer=False)
    m, B = shape[4], shape[5]
    assert tk.hist_dtype(bins.device) == dtype
    got = tk.histogram_grid(bins, stats, pos, m, B)
    ref = tk.histogram_torch(bins, stats, pos, m, B)
    scale = tk.histogram_torch(bins, stats.abs(), pos, m, B)
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() <= 1e-4 * scale + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HIST_SHAPES[:4])
def test_tree_histogram_is_deterministic_and_batch_independent(card, shape):
    bins, stats, pos = _hist_inputs(card, shape, integer=False, seed=3)
    m, B = shape[4], shape[5]
    a = tk.histogram_grid(bins, stats, pos, m, B)
    b = tk.histogram_grid(bins, stats, pos, m, B)
    assert torch.equal(a, b)
    for g in (0, shape[0] - 1):
        one = tk.histogram_grid(bins, stats[g:g + 1].contiguous(),
                                pos[g:g + 1].contiguous(), m, B)
        assert torch.equal(one[0], a[g])


@pytest.mark.cuda
def test_tree_histogram_out_of_range_rows_and_empty_input(card, monkeypatch):
    """Nodes outside [0, m) and bins outside [0, B) add nothing, as in
    the plain version; no rows gives zeros."""
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    bins, stats, pos = _hist_inputs(card, (3, 5_000, 6, 3, 4, 16),
                                    integer=True)
    pos[0, :700] = -1
    pos[1, 100:900] = 4
    bins[200:300, 2] = 16
    bins[400:450, 0] = -3
    got = tk.histogram_grid(bins, stats, pos, 4, 16)
    assert torch.equal(got, tk.histogram_torch(bins, stats, pos, 4, 16))
    empty = tk.histogram_grid(bins[:0], stats[:, :0].contiguous(),
                              pos[:, :0].contiguous(), 4, 16)
    assert empty.shape == (3, 4 * 3, 6 * 16)
    assert torch.count_nonzero(empty) == 0


@pytest.mark.cuda
def test_tree_histogram_rejects_bad_input(card):
    bins = torch.zeros((8, 4), dtype=torch.int32, device=card)
    stats = torch.zeros((2, 8, 3), device=card)
    pos = torch.zeros((2, 8), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        tk.histogram_grid(bins.t().contiguous().t(), stats, pos, 2, 4)
    with pytest.raises(ValueError, match="different devices"):
        tk.histogram_grid(bins, stats.cpu(), pos, 2, 4)
    with pytest.raises(TypeError, match="float32"):
        tk.histogram_grid(bins, stats.half(), pos, 2, 4)


@pytest.mark.cuda
def test_selector_on_cuda_launches_the_histogram_kernel(card):
    """One short tree-selector fit on the card: every tree level of the
    folded grid and of the refit is one kernel launch."""
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.features import types as ft
    rng = np.random.default_rng(1)
    X = rng.normal(size=(3000, 6)).astype(np.float32)
    y = ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.float32)
    ds = Dataset({"y": y.astype(np.float64), "x": X},
                 {"y": ft.RealNN, "x": ft.OPVector})
    lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
    vec = FeatureBuilder.OPVector("x").from_column().as_predictor()
    sel = TM.BinaryClassificationModelSelector.with_cross_validation(
        candidates=["DecisionTreeClassifier", "GBTClassifier"]
    ).set_input(lbl, vec)
    before = tk.histogram_grid.launches
    model = sel.fit(ds)
    launches = tk.histogram_grid.launches - before
    dt = TM.MODEL_FAMILIES["DecisionTreeClassifier"].levels_per_fit()
    gbt = TM.MODEL_FAMILIES["GBTClassifier"].levels_per_fit()
    winner = TM.MODEL_FAMILIES[model.summary["bestModel"]["family"]]
    assert launches == dt + gbt + winner.levels_per_fit()
    assert model.device.type == "cuda"
    assert model.summary["holdoutEvaluation"]["AuROC"] > 0.9
