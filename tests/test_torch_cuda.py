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
    """Ragged n, one model, a softmax head's raw scores, and a weight
    block above the default 48 KB of shared memory (200 x 71 x 1 f32,
    staged through the opt-in limit); the last model holds inf and no
    row selects it. f32 accumulation in another order than the plain
    version's GEMM: rtol = atol = 1e-4."""
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
@pytest.mark.parametrize("act,L", [("sigmoid_pair", 1), ("softmax", 3),
                                   ("identity", 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_identity_table_with_a_heads_activation_matches_plain(card, act, L,
                                                             dtype):
    """``fused_linear_scores(..., act=)``, the generic form's one
    launch: the identity table through a head's activation against the
    plain contraction and ``apply_activation``; a row outside [0, K)
    gets z = 0 before the activation. rtol = atol = 1e-4."""
    rng = np.random.default_rng(L)
    n, p, K = 64, 1 if act == "sigmoid_pair" else 24, 4
    X = rng.normal(size=(n, p)).astype(np.float32)
    W = (0.5 * rng.normal(size=(K, p + 1, L))).astype(np.float32)
    mid = rng.integers(0, K, size=n).astype(np.int32)
    mid[0] = K
    Xt, Wt, mt = (torch.from_numpy(a).to(card) for a in (X, W, mid))
    before = sk.fused_linear_scores.launches
    got = sk.fused_linear_scores(Xt, Wt, mt, act=act, dtype=dtype)
    torch.cuda.synchronize()
    assert sk.fused_linear_scores.launches == before + 1
    ref = sk.apply_activation(
        act, sk.fused_linear_scores_torch(Xt, Wt, mt, dtype=dtype))
    assert got.shape == ref.shape == (n, 2 if act == "sigmoid_pair" else L)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_generic_form_pass_is_one_launch_per_bucket_slice(card,
                                                          monkeypatch):
    """Model-stacking members (an inner predict before the head) on the
    card: the generic form, 150 rows over three bucket slices, one
    launch each; every row within chip_smoke's SERVE_ATOL of its
    model's numpy score under bf16 operands."""
    import chip_smoke
    from transmogrifai_tpu_torch import portable
    from transmogrifai_tpu_torch.serving.fusion import (GENERIC,
                                                        FusedGroupScorer,
                                                        stack_spec_of)
    monkeypatch.delenv("TM_KERNEL_EXACT", raising=False)
    rng = np.random.default_rng(5)
    members, pars = [], []
    for k in range(3):
        m, a, par = chip_smoke.make_stacked_ir(rng, f"out{k}")
        sc = portable.from_portable(m, a, card).compile_scoring(
            buckets=chip_smoke.BUCKETS)
        backend = type("Backend", (), {"scorer": sc})()
        members.append((backend, stack_spec_of(backend)))
        pars.append(par)
    assert all(spec.form == GENERIC for _b, spec in members)
    n = 150
    cols = {f"x{i}": np.where(rng.random(n) < 0.05, np.nan,
                              rng.normal(size=n))
            for i in range(chip_smoke.N_COLUMNS)}
    mid = rng.integers(0, 3, size=n).astype(np.int32)
    _n, vals = members[0][0].scorer._boundary_host(cols)
    scorer = FusedGroupScorer(members)
    assert scorer._tails is None and scorer.dtype == torch.bfloat16
    before = sk.fused_linear_scores.launches
    got = scorer.finalize(scorer.launch(n, vals, mid))
    assert sk.fused_linear_scores.launches == before + 3
    for k in range(3):
        err = min(np.abs(got[mid == k] - want[mid == k]).max() for want in
                  chip_smoke.stacked_oracle(cols, pars[k], bf16=True))
        assert err <= chip_smoke.SERVE_ATOL


@pytest.mark.cuda
def test_table_form_reads_vector_boundary_columns_on_the_card(card):
    """Vector boundary columns packed as consecutive slots (C = 41, as
    Titanic's pivots give it): the kernel's features bit for bit the
    members' eager prefixes (an identity head, f32 operands), a concat
    of a scalar impute and two vectors under a keep subset."""
    from transmogrifai_tpu_torch.ops import (RealVectorizerModel,
                                             SanityCheckerModel,
                                             VectorsCombiner)
    from transmogrifai_tpu_torch.serving.fusion import (compile_prefix,
                                                        pack_slice)
    rng = np.random.default_rng(3)
    n, bucket = 50, 64
    stages = [RealVectorizerModel(fill_value=0.5, track_nulls=True
                                  ).wire(["age"], "age_v"),
              VectorsCombiner().wire(["age_v", "sex", "cabin"], "all"),
              SanityCheckerModel(keep_indices=[0, 1, 3, 6, 20, 25, 26]
                                 ).wire(["y", "all"], "kept")]
    infos = [(st.input_names, st.make_device_fn(), st.output.name)
             for st in stages] + [(["y", "kept"], None, "pred")]
    sc = type("Scorer", (), {
        "boundary": ["age", "sex", "cabin", "y"], "device_infos": infos,
        "device_stage_by_output": {st.output.name: st for st in stages}})()
    age = np.where(rng.random(n) < 0.2, np.nan, rng.normal(size=n))
    sex = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
    cabin = np.eye(22, dtype=np.float32)[rng.integers(0, 22, n)]
    vals = [age.astype(np.float32), sex, cabin, np.zeros(n, np.float32)]
    shapes = [v.shape[1:] for v in vals]
    src, op, fill = compile_prefix(sc, "kept", shapes)
    C, p = 1 + 5 + 22 + 1, len(src)
    host = np.empty(bucket * (C + 1), np.float32)
    pack_slice(host, bucket, vals, np.zeros(n, np.int32))
    V = torch.from_numpy(host[:bucket * C].reshape(bucket, C)).to(card)
    mid = torch.from_numpy(host[bucket * C:].view(np.int32)).to(card)
    W = torch.zeros((1, p + 1, p), device=card)
    W[0, :p, :] = torch.eye(p, device=card)
    tables = [torch.from_numpy(t[None]).to(card) for t in (src, op, fill)]
    got = sk.fused_prefix_scores(V, mid, *tables, W, act="identity",
                                 dtype=torch.float32)[:n]
    cols = dict(zip(sc.boundary, [torch.from_numpy(v).to(card)
                                  for v in vals]))
    for in_names, fn, out in infos[:-1]:
        cols[out] = fn(*[cols[nm] for nm in in_names])
    assert torch.equal(got.view(torch.int32),
                       cols["kept"].view(torch.int32))


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


#: (n, C, p, K, L, act): the serving pass (13 boundary columns, 22 kept
#: features, 4 models, a binary head), a softmax head, an identity head,
#: and a group too large for shared memory (W alone is 512 x 65 x 3 f32,
#: 400 KB), read through L1
PREFIX_CASES = [(64, 13, 22, 4, 1, "sigmoid_pair"), (37, 13, 22, 4, 3,
                                                    "softmax"),
                (64, 13, 22, 4, 1, "identity"),
                (300, 70, 64, 512, 3, "softmax")]


def _prefix_case(card, n, C, p, K, L, seed):
    """NaN in 5% of the values and all of column 0, model K-1 all inf
    and selected by no row, two rows with mid outside [0, K)."""
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n, C)).astype(np.float32)
    V[rng.random((n, C)) < 0.05] = np.nan
    V[:, 0] = np.nan
    src = rng.integers(0, C, size=(K, p)).astype(np.int32)
    op = rng.integers(sk.OP_FILLED, sk.OP_NULL + 1,
                      size=(K, p)).astype(np.uint8)
    fill = rng.normal(size=(K, p)).astype(np.float32)
    W = (0.5 * rng.normal(size=(K, p + 1, L))).astype(np.float32)
    W[K - 1] = np.inf
    mid = rng.integers(0, K - 1, size=n).astype(np.int32)
    mid[:2] = (-1, K)
    return [torch.from_numpy(a).to(card)
            for a in (V, mid, src, op, fill, W)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PREFIX_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_prefix_scores_kernel_matches_plain(card, case, dtype):
    """The prefix form in one launch against its plain version: f32
    accumulation in another order, expf against torch's exp: rtol =
    atol = 1e-4 (chip_smoke's KERNEL_RTOL); finite everywhere."""
    n, C, p, K, L, act = case
    args = _prefix_case(card, n, C, p, K, L, n + p + K)
    before = sk.fused_linear_scores.launches
    got = sk.fused_prefix_scores(*args, act=act, dtype=dtype)
    torch.cuda.synchronize()
    assert sk.fused_linear_scores.launches == before + 1
    ref = sk.fused_prefix_scores_torch(*args, act=act, dtype=dtype)
    assert got.shape == ref.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [22, 64])
def test_fused_prefix_features_are_bitwise_on_the_card(card, p):
    """f32 operands, W[k] the identity (L = p) with a zero intercept:
    each score is exactly one feature (the other products are exact
    zeros), so the kernel's features equal the plain version's bit for
    bit. p = 64 puts two features on each lane."""
    n, C, K = 64, 13, 4
    V, mid, src, op, fill, _W = _prefix_case(card, n, C, p, K, 1, p)
    mid = mid.clamp(0, K - 1).contiguous()
    W = torch.zeros((K, p + 1, p), device=card)
    W[:, :p, :] = torch.eye(p, device=card)
    got = sk.fused_prefix_scores(V, mid, src, op, fill, W, act="identity",
                                 dtype=torch.float32)
    want = sk.prefix_features_torch(V, mid, src, op, fill)
    ref = sk.fused_prefix_scores_torch(V, mid, src, op, fill, W,
                                       act="identity", dtype=torch.float32)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(ref.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_fused_pass_is_one_launch_per_bucket_slice(card, monkeypatch):
    """The stacked branch on the card: 150 rows over the serving
    catalog's four members take three bucket slices (64, 64, 22 padded
    to 64), one launch each; every row within chip_smoke's SERVE_ATOL
    of its model's numpy score under bf16 operands."""
    import chip_smoke
    from transmogrifai_tpu_torch.serving.fusion import (FusedGroupScorer,
                                                        stack_spec_of)
    monkeypatch.delenv("TM_KERNEL_EXACT", raising=False)
    reg, catalog = chip_smoke.build_catalog(3, card)
    names = [f"m{k:03d}" for k in range(chip_smoke.N_BACKENDS)]
    members = []
    for name in names:
        with reg.acquire(name) as (_vname, backend):
            members.append((backend, stack_spec_of(backend)))
    rng = np.random.default_rng(2)
    n = 150
    cols = {f"x{i}": np.where(rng.random(n) < 0.05, np.nan,
                              rng.normal(size=n))
            for i in range(chip_smoke.N_COLUMNS)}
    mid = rng.integers(0, len(names), size=n).astype(np.int32)
    _n, vals = members[0][0].prepare(cols)
    scorer = FusedGroupScorer(members)
    assert scorer._tails is None and scorer.dtype == torch.bfloat16
    before = sk.fused_linear_scores.launches
    got = scorer.finalize(scorer.launch(n, vals, mid))
    assert sk.fused_linear_scores.launches == before + 3
    for k, name in enumerate(names):
        want = chip_smoke.oracle_probs(cols, catalog[name][1], bf16=True)
        np.testing.assert_allclose(got[mid == k], want[mid == k],
                                   atol=chip_smoke.SERVE_ATOL)


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
    """f32 sums in another order than the plain version's GEMM (the
    tensor cores' chain over each 128-row tile, tiles and then runs
    summed in order): each cell within 1e-4 of the sum of its |terms|.
    The operand dtype comes from the knobs, as on the training path."""
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


def _hist_check(card, G, n, d, S, m, B, seed=0):
    """Exact mode on integer stats bitwise, and bf16 operands on float
    stats within 1e-4 of the sum of |terms| (f32 sums in another
    order), at one shape."""
    bins, istats, pos = _hist_inputs(card, (G, n, d, S, m, B), True, seed)
    fstats = torch.randn((G, n, S), generator=torch.Generator(
        device=card).manual_seed(seed), device=card)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TM_KERNEL_EXACT", "1")
        got = tk.histogram_grid(bins, istats, pos, m, B)
        assert torch.equal(got, tk.histogram_torch(bins, istats, pos, m, B))
        mp.setenv("TM_KERNEL_EXACT", "0")
        mp.setenv("TM_HIST_BF16", "1")
        got = tk.histogram_grid(bins, fstats, pos, m, B)
        ref = tk.histogram_torch(bins, fstats, pos, m, B)
        scale = tk.histogram_torch(bins, fstats.abs(), pos, m, B)
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() <= 1e-4 * scale + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 3, 5, 7, 8, 9, 21])
@pytest.mark.parametrize("B", [2, 16, 32, 33, 64])
def test_tree_histogram_stat_and_bin_tiles(card, S, B):
    """Stats past one 8-column B tile (9, 21) and bins past one 32-bin
    group (33, 64), or within one 16-bin A tile (2, 16): every group
    and tile edge, with 11 features (not a multiple of a warp's 4) and
    a row count that leaves a partial tile."""
    _hist_check(card, 2, 3_001, 11, S, 3, B, seed=S * 100 + B)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [255, 256, 300])
def test_tree_histogram_many_bin_groups(card, B):
    """8 to 10 groups of 32 bins, each packed apart as bytes relative to
    the group (255 outside it), the last one ragged."""
    _hist_check(card, 2, 2_001, 13, 3, 2, B, seed=B)


@pytest.mark.cuda
def test_tree_histogram_ragged_features_single_node_and_empty_nodes(
        card, monkeypatch):
    """d = 37 (a second feature chunk of 5) and d = 1; m = 1; nodes that
    hold no row (zeros), rows on nodes outside [0, m) and bins outside
    [0, B), exact mode bitwise."""
    _hist_check(card, 3, 2_500, 37, 5, 1, 32, seed=1)
    _hist_check(card, 1, 700, 1, 3, 1, 32, seed=2)
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    bins, stats, pos = _hist_inputs(card, (4, 6_000, 13, 3, 8, 32),
                                    integer=True, seed=3)
    pos[0] = torch.where(pos[0] >= 4, pos[0] - 4, pos[0])   # 4..7 empty
    pos[1, ::3] = 8
    pos[2, 1::5] = -2
    bins[::7, 3] = 32
    bins[1::9, 12] = -1
    got = tk.histogram_grid(bins, stats, pos, 8, 32)
    assert torch.equal(got, tk.histogram_torch(bins, stats, pos, 8, 32))
    assert torch.count_nonzero(got[0].reshape(8, -1)[4:]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("exact", ["1", "0"])
def test_tree_histogram_nan_stat_spreads_in_its_node_feature_and_stat(
        card, exact, monkeypatch):
    """A NaN stat turns every bin of its node, every feature and its
    stat into NaN (the one-hot's zeros multiply it); every other cell
    is the histogram of the other rows."""
    monkeypatch.setenv("TM_KERNEL_EXACT", exact)
    monkeypatch.setenv("TM_HIST_BF16", "1")
    G, n, d, S, m, B = 2, 4_000, 6, 3, 4, 32
    bins, stats, pos = _hist_inputs(card, (G, n, d, S, m, B), True, seed=4)
    row, s_nan = 1234, 1
    node = int(pos[0, row])
    stats[0, row, s_nan] = float("nan")
    got = tk.histogram_grid(bins, stats, pos, m, B).reshape(G, m, S, d, B)
    clean = stats.clone()
    clean[0, row, s_nan] = 0.0
    want = tk.histogram_torch(bins, clean, pos, m, B).reshape(G, m, S, d, B)
    nan = torch.zeros_like(got, dtype=torch.bool)
    nan[0, node, s_nan] = True
    assert torch.isnan(got[nan]).all()
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.cuda
def test_tree_histogram_exact_mode_splits_stats_in_three(card, monkeypatch):
    """Integer stats of up to 12 significant bits need the hi and mid
    bf16 terms (8 bits each), dyadic ones of 17 bits all three: exact
    mode stays bitwise the plain version's while every partial sum is
    exact in f32 (at most 2^23 units of the last place); bf16 mode
    rounds the same stats (and so differs)."""
    G, n, d, S, m, B = 2, 4_000, 7, 5, 2, 32
    gen = torch.Generator(device=card).manual_seed(5)
    bins, _s, pos = _hist_inputs(card, (G, n, d, S, m, B), True, seed=5)
    wide = torch.randint(-4095, 4096, (G, n, S), generator=gen,
                         device=card).to(torch.float32)
    sign = torch.randint(0, 2, (G, n, S), generator=gen, device=card) * 2 - 1
    fine = (sign * torch.randint(1 << 16, 1 << 17, (G, n, S), generator=gen,
                                 device=card)).to(torch.float32) / (1 << 23)
    fine[:, 64:] = 0.0           # 64 rows: every partial sum < 2^23 ulp
    for stats in (wide, fine):
        monkeypatch.setenv("TM_KERNEL_EXACT", "1")
        got = tk.histogram_grid(bins, stats, pos, m, B)
        assert torch.equal(got, tk.histogram_torch(bins, stats, pos, m, B))
        monkeypatch.setenv("TM_KERNEL_EXACT", "0")
        monkeypatch.setenv("TM_HIST_BF16", "1")
        assert not torch.equal(tk.histogram_grid(bins, stats, pos, m, B),
                               got)


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


# ---------------------------------------------------------------------------
# ring_allreduce (ranks on one card: each rank its own stream; the
# kernel, flags and barriers are those of ranks on peer cards)
# ---------------------------------------------------------------------------

from transmogrifai_tpu_torch import parallel as par   # noqa: E402


def _ring_parts(card, ndev, shape, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=card)
            for _ in range(ndev)]


@pytest.mark.cuda
@pytest.mark.parametrize("ndev", [2, 3, 4])
@pytest.mark.parametrize("shape", [(16, 40, 896), (12, 48, 896), (7, 13)])
def test_ring_kernel_is_bitwise_the_plain_version(card, ndev, shape):
    """All-gather: each rank's (ndev, ...) output is the parts in origin
    order, exactly. All-reduce: every rank the same bits as the plain
    version's left-to-right f32 sum. One launch a rank a call."""
    mesh = par.data_mesh([card] * ndev)
    parts = _ring_parts(card, ndev, shape, seed=ndev)
    before = (tk.ring_allgather.launches, tk.ring_allreduce.launches)
    gathered = tk.ring_allgather(parts, mesh)
    reduced = tk.ring_allreduce(parts, mesh)
    torch.cuda.synchronize()
    assert (tk.ring_allgather.launches, tk.ring_allreduce.launches) == (
        before[0] + ndev, before[1] + ndev)
    stacked = torch.stack(parts)
    ref = tk.ring_allreduce_torch(parts)
    for r in range(ndev):
        assert torch.equal(gathered[r], stacked)
        assert torch.equal(reduced[r], ref[r])
        assert torch.equal(reduced[r], reduced[0])


@pytest.mark.cuda
@pytest.mark.parametrize("numel", [0, 1, 3, 4097, 1_000_003])
def test_ring_kernel_odd_sizes(card, numel):
    mesh = par.data_mesh([card] * 3)
    parts = _ring_parts(card, 3, (numel,), seed=numel)
    # an offset view: not 16-byte aligned, the kernel's scalar path
    odd = [torch.randn(numel + 1, device=card)[1:] for _ in range(3)]
    for ps in (parts, odd):
        red = tk.ring_allreduce(ps, mesh)
        gat = tk.ring_allgather(ps, mesh)
        torch.cuda.synchronize()
        ref = tk.ring_allreduce_torch(ps)
        for r in range(3):
            assert torch.equal(red[r], ref[r])
            assert torch.equal(gat[r], torch.stack(ps))


@pytest.mark.cuda
def test_ring_kernel_rejects_other_dtypes(card):
    mesh = par.data_mesh([card] * 2)
    parts = [torch.zeros(8, dtype=torch.float64, device=card)] * 2
    with pytest.raises(TypeError, match="float32 only"):
        tk.ring_allreduce(parts, mesh)
    with pytest.raises(ValueError, match="shape|rank 0"):
        tk.ring_allreduce([torch.zeros(8, device=card),
                           torch.zeros(9, device=card)], mesh)


@pytest.mark.cuda
def test_ring_kernel_back_to_back_calls(card):
    """200 calls with changing inputs and no host synchronisation between
    them (the epoch and the neighbour barrier): every output right."""
    mesh = par.data_mesh([card] * 4)
    calls = [_ring_parts(card, 4, (12, 48, 896), seed=i) for i in range(200)]
    outs = [tk.ring_allreduce(ps, mesh) for ps in calls]
    torch.cuda.synchronize()
    for ps, out in zip(calls, outs):
        ref = tk.ring_allreduce_torch(ps)
        assert all(torch.equal(o, ref[0]) for o in out)


@pytest.mark.cuda
@pytest.mark.parametrize("gather", [False, True])
def test_ring_kernel_exit_barrier_race_probe(card, gather):
    """200 calls back to back, every input overwritten with NaN on its
    own rank stream right after its call: a rank still reading another
    rank's input once that rank's kernel ended (an exit barrier at
    fault) would read NaN. Every output stays bitwise right."""
    mesh = par.data_mesh([card] * 4)
    calls = [_ring_parts(card, 4, (12, 48, 896), seed=7 + i)
             for i in range(200)]
    if gather:
        wants = [[torch.stack(ps)] * 4 for ps in calls]
    else:
        wants = [tk.ring_allreduce_torch(ps) for ps in calls]
    op = tk.ring_allgather if gather else tk.ring_allreduce
    outs = []
    for ps in calls:
        outs.append(op(ps, mesh))
        for r, p in enumerate(ps):
            with mesh.rank(r):
                p.fill_(float("nan"))
    torch.cuda.synchronize()
    for want, out in zip(wants, outs):
        assert all(torch.equal(o, w) for o, w in zip(out, want))


@pytest.mark.cuda
def test_ring_kernel_enables_peer_access_between_every_pair(card):
    """Every rank reads every input and writes every output, so peer
    access must be on between every pair of distinct cards, not only
    neighbours: ranks ordered so that cards meet out of ring order
    (and some twice) still give every rank the plain version's bits."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("one card: the peer-access path needs two or more")
    cards = [torch.device("cuda", i) for i in range(min(n, 4))]
    for a, b in tk.peer_pairs(cards):
        assert torch.cuda.can_device_access_peer(a.index, b.index)
    devs = cards[::2] + cards[1::2] + cards[:1]
    mesh = par.data_mesh(devs)
    parts = [torch.randn(16, 40, 896, device=d) for d in devs]
    red = tk.ring_allreduce(parts, mesh)
    gat = tk.ring_allgather(parts, mesh)
    for d in cards:
        torch.cuda.synchronize(d)
    ref = tk.ring_allreduce_torch(parts)
    stacked = torch.stack([p.cpu() for p in parts])
    for r in range(len(devs)):
        assert red[r].device == devs[r]
        assert torch.equal(red[r].cpu(), ref[0].cpu())
        assert torch.equal(gat[r].cpu(), stacked)


@pytest.mark.cuda
def test_ring_kernel_over_peer_cards(card):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("one card: the peer-access path needs two or more")
    devs = [torch.device("cuda", i) for i in range(min(n, 4))]
    mesh = par.data_mesh(devs)
    parts = [torch.randn(16, 40, 896, device=d) for d in devs]
    red = tk.ring_allreduce(parts, mesh)
    for d in devs:
        torch.cuda.synchronize(d)
    ref = tk.ring_allreduce_torch(parts)
    for r, d in enumerate(devs):
        assert torch.equal(red[r].cpu(), ref[0].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("ring", ["1", "0"])
def test_grow_over_a_data_mesh_equals_the_single_grow(card, ring,
                                                      monkeypatch):
    """GBT's first-round stats (dyadic: every order of summation is
    exact) under fold-mask weights, rows over 4 ranks of one card: the
    trees of every rank bitwise those of the single-device grow."""
    from transmogrifai_tpu_torch.models import trees as TT
    monkeypatch.setenv("TM_MESH_RDMA_RING", ring)
    rng = np.random.default_rng(5)
    n, d, Gb = 20_003, 28, 6
    X = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(card)
    y = (X[:, 0] * X[:, 1] > 0).float()
    w = torch.from_numpy((rng.random((Gb, n)) < 0.67).astype(np.float32)
                         ).to(card)
    bins, edges = TT._prep(X, 32, torch.ones(n, device=card))
    gw = ((0.5 - y)[None, :, None] * w[..., None]).contiguous()
    hw = (0.25 * w[..., None]).contiguous()
    rep = (edges, torch.ones((Gb, d), device=card),
           torch.ones(Gb, device=card), torch.zeros(Gb, device=card),
           torch.ones(Gb, device=card), torch.full((Gb,), 5.0, device=card))
    single = TT.grow_tree_grid(bins, gw, hw, w, *rep, max_depth=5)
    mesh = par.data_mesh([card] * 4)
    before = tk.ring_allreduce.launches
    out = TT.grow_tree_grid(par.shard_rows(bins, mesh),
                            par.shard_rows(gw, mesh, 1),
                            par.shard_rows(hw, mesh, 1),
                            par.shard_rows(w, mesh, 1), *rep, max_depth=5,
                            mesh=mesh)
    torch.cuda.synchronize()
    assert tk.ring_allreduce.launches - before == (
        4 * (5 + 1) if ring == "1" else 0)
    for res in out:
        for a, b in zip(single[:4], res[:4]):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_sharded_statistics_on_ranks_sharing_the_card(card, monkeypatch):
    """sharded_statistics over 4 ranks of one card: two sums and two
    gathers, one launch a rank each; the ring bitwise the plain version
    (TM_MESH_RDMA_RING=0); every key within the CPU tests' tolerance of
    the one-rank statistics."""
    from transmogrifai_tpu_torch.ops.sanity_checker import compute_statistics
    rng = np.random.default_rng(8)
    X = rng.normal(size=(20_003, 9)).astype(np.float32)
    X[:, 4] = 1.0
    y = (rng.random(20_003) > 0.4).astype(np.float32)
    mesh = par.data_mesh([card] * 4)
    before = (tk.ring_allreduce.launches, tk.ring_allgather.launches)
    ring = par.sharded_statistics(X, y, mesh)
    assert (tk.ring_allreduce.launches - before[0],
            tk.ring_allgather.launches - before[1]) == (8, 8)
    monkeypatch.setenv("TM_MESH_RDMA_RING", "0")
    plain = par.sharded_statistics(X, y, mesh)
    one = compute_statistics(X, y, card)
    for k in one:
        assert np.array_equal(ring[k], plain[k], equal_nan=True), k
        rtol, atol = (1e-3, 1e-4) if k == "spearman" else (1e-4, 1e-5)
        np.testing.assert_allclose(ring[k], one[k], rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["lr", "fm", "softmax"])
def test_sharded_sparse_fits_on_ranks_sharing_the_card(card, family,
                                                       monkeypatch):
    """The sharded fits over 3 ranks of one card (uneven shards of a
    4,096-row batch, a padded last batch, lazy L2): within 1e-4 of the
    one-device fit, the ring bitwise the plain version, one ring launch
    a rank a step."""
    from transmogrifai_tpu_torch.models import sparse as TS
    rng = np.random.default_rng(9)
    n, B = 20_000, 1 << 14
    idx = rng.integers(0, B, (n, 6)).astype(np.int32)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    kw = dict(lr=0.05, l2=1e-4, epochs=2, batch_size=4096)
    mesh = par.data_mesh([card] * 3)
    if family == "softmax":
        y = rng.integers(0, 3, n).astype(np.float32)
        args = (idx, X, y, w, B, 3)
        single_fn, sharded_fn = TS.fit_sparse_softmax, \
            TS.fit_sparse_softmax_sharded
    else:
        y = (rng.random(n) < 0.3).astype(np.float32)
        args = (idx, X, y, w, B)
        single_fn, sharded_fn = {
            "lr": (TS.fit_sparse_lr, TS.fit_sparse_lr_sharded),
            "fm": (TS.fit_sparse_fm, TS.fit_sparse_fm_sharded)}[family]
    single = single_fn(*args, device=card, **kw)
    before = tk.ring_allreduce.launches
    ring = sharded_fn(*args, mesh=mesh, **kw)
    assert tk.ring_allreduce.launches - before == 5 * 2 * 3
    monkeypatch.setenv("TM_MESH_RDMA_RING", "0")
    plain = sharded_fn(*args, mesh=mesh, **kw)
    for k in single:
        assert np.array_equal(ring[k], plain[k]), k
        np.testing.assert_allclose(ring[k], single[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.cuda
def test_grid_sharded_sweep_is_bitwise_on_ranks_sharing_the_card(card):
    """The fused sweep of LR, NB and a folded GBT over grid meshes of 1,
    2 and 4 ranks of one card (each rank its own stream): the metrics
    bitwise the one-device sweep's, and the histogram launched by every
    rank for every level of its shard."""
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES as MF
    from transmogrifai_tpu_torch.models.tuning import OpCrossValidation
    rng = np.random.default_rng(10)
    n = 6000
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + X[:, 2] > 0).astype(np.float32)
    w = np.ones(n, np.float32)
    entries = [(name, MF[name], MF[name].make_grid())
               for name in ("LogisticRegression", "NaiveBayes",
                            "GBTClassifier")]
    cv = OpCrossValidation(n_folds=3, metric="auroc")

    def run(mesh):
        before = tk.histogram_grid.launches
        pend = cv.dispatch_many(entries, X, y, w, 2, mesh, device=card)
        out = {k: cv.collect(p).grid_metrics for k, p in pend.items()}
        return out, tk.histogram_grid.launches - before

    one, one_launches = run(None)
    assert one_launches == MF["GBTClassifier"].levels_per_fit()
    for k in (1, 2, 4):
        got, launches = run(par.get_mesh([card] * k))
        assert launches == k * one_launches
        for key in one:
            assert np.array_equal(one[key], got[key]), (key, k)


# ---------------------------------------------------------------------------
# The linear sweep on the card (no kernel of its own: torch products and
# solves), against the port's CPU path and against itself
# ---------------------------------------------------------------------------

def _linear_entries(problem):
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES as MF
    names = {"binary": ["LinearSVC", "LogisticRegression", "NaiveBayes"],
             "multiclass": ["LogisticRegression", "NaiveBayes"],
             "regression": ["LinearRegression",
                            "GeneralizedLinearRegression"]}[problem]
    return [(n, MF[n], MF[n].make_grid()) for n in names]


@pytest.mark.cuda
@pytest.mark.parametrize("problem,k,metric", [("binary", 2, "auroc"),
                                              ("multiclass", 3, "logloss"),
                                              ("regression", 1, "rmse")])
def test_linear_sweep_on_the_card_matches_the_cpu(card, problem, k, metric):
    """Every default grid point of the problem's linear families on the
    card and on the CPU: the same f32 program summed in another order,
    within 1e-4 (relative for the RMSE)."""
    import chip_smoke
    from transmogrifai_tpu_torch.models.tuning import OpCrossValidation
    X, y = chip_smoke.problem_data(1, 4000, problem)
    w = np.ones(len(y), np.float32)
    got = {}
    for dev in ("cuda", "cpu"):
        cv = OpCrossValidation(n_folds=3, metric=metric)
        got[dev] = {key: cv.collect(p).grid_metrics for key, p in
                    cv.dispatch_many(_linear_entries(problem), X, y, w, k,
                                     device=dev).items()}
    for key in got["cpu"]:
        np.testing.assert_allclose(got["cuda"][key], got["cpu"][key],
                                   rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("slice_", ["1", "0"])
def test_linear_sweep_items_are_bitwise_independent_on_the_card(
        card, slice_, monkeypatch):
    """A candidate alone, and stacked with a second one (its items then
    sit elsewhere in their chunks of 16), gives bitwise-equal metrics on
    the card, gathered or masked folds alike."""
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES as MF
    from transmogrifai_tpu_torch.models.tuning import OpCrossValidation
    import chip_smoke
    monkeypatch.setenv("TM_SWEEP_FOLD_SLICE", slice_)
    X, y = chip_smoke.problem_data(2, 12000, "binary")
    w = np.ones(len(y), np.float32)
    lr = MF["LogisticRegression"]
    one = ("one", lr, lr.make_grid())
    two = ("two", lr, lr.make_grid({"regParam": [0.05, 0.2],
                                    "elasticNetParam": [0.0, 0.5]}))
    cv = OpCrossValidation(n_folds=3, metric="logloss")
    alone = cv.collect(cv.dispatch_many([one], X, y, w, 2, device="cuda")["one"])
    both = cv.collect(cv.dispatch_many([one, two], X, y, w, 2,
                                       device="cuda")["one"])
    assert np.array_equal(alone.grid_metrics, both.grid_metrics)


@pytest.mark.cuda
def test_linear_sweep_dispatch_never_waits_on_the_card(card):
    """The linear families' dispatch (every problem, gathered and masked
    folds, static and traced GLM links) runs under sync debug mode
    "error": nothing in it makes the host wait for the card."""
    import chip_smoke
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES as MF
    from transmogrifai_tpu_torch.models.tuning import OpCrossValidation
    glm = MF["GeneralizedLinearRegression"]
    for knobs in ({}, {"TM_SWEEP_FOLD_SLICE": "0"}):
        for problem, k in (("binary", 2), ("multiclass", 3),
                           ("regression", 1)):
            X, y = chip_smoke.problem_data(3, 10000, problem)
            entries = _linear_entries(problem)
            if problem == "regression":
                entries.append(("glm_traced", glm, glm.make_grid(
                    {"familyLink": [0.0, 1.0, 2.0, 3.0]})))
            cv = OpCrossValidation(n_folds=3, metric="rmse" if k == 1
                                   else "error")
            with chip_smoke.env(**knobs):
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    pend = cv.dispatch_many(entries, X, y,
                                            np.ones(len(y), np.float32),
                                            k, device="cuda")
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            for p in pend.values():
                assert np.isfinite(cv.collect(p).grid_metrics[:2]).all()


@pytest.mark.cuda
def test_grid_data_runner_on_two_by_two_ranks_of_the_card(card):
    """The fused sweep of LR, NB and a folded DT and GBT on a 2 x 2 grid
    x data mesh of one card's ranks against one device: DT bitwise
    (integer-valued stats), LR and NB within the CPU tests' 1e-4 / 1e-6,
    GBT within 1e-2, the same best grid point; the histogram launched by
    every rank of every grid row for every level of its row's shard; the
    ring's sums and gathers launched."""
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES as MF
    from transmogrifai_tpu_torch.models.tuning import OpCrossValidation
    rng = np.random.default_rng(11)
    n = 6000
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + X[:, 2] > 0).astype(np.float32)
    w = np.ones(n, np.float32)
    names = ("LogisticRegression", "NaiveBayes", "DecisionTreeClassifier",
             "GBTClassifier")
    entries = [(name, MF[name], MF[name].make_grid()) for name in names]
    cv = OpCrossValidation(n_folds=3, metric="auroc")

    def run(mesh):
        before = tk.histogram_grid.launches
        pend = cv.dispatch_many(entries, X, y, w, 2, mesh, device=card)
        out = {k: cv.collect(p) for k, p in pend.items()}
        return out, tk.histogram_grid.launches - before

    one, one_launches = run(None)
    r0 = (tk.ring_allreduce.launches, tk.ring_allgather.launches)
    got, launches = run(par.get_mesh_2d([card] * 4))
    assert launches == 4 * one_launches
    assert tk.ring_allreduce.launches > r0[0]
    assert tk.ring_allgather.launches > r0[1]
    for key, res in one.items():
        g = got[key]
        if key == "DecisionTreeClassifier":
            assert np.array_equal(g.grid_metrics, res.grid_metrics)
        elif key == "GBTClassifier":
            np.testing.assert_allclose(g.grid_metrics, res.grid_metrics,
                                       rtol=0, atol=1e-2)
        else:
            np.testing.assert_allclose(g.grid_metrics, res.grid_metrics,
                                       rtol=1e-4, atol=1e-6, err_msg=key)
        assert g.best_index == res.best_index, key


#: FT-Transformer's row-sharded fit against one device on the card
#: (f32 products of another blocking per shard): read 1.2e-7 on the
#: parameters and 3.0e-7 on the probabilities (NVIDIA H100 80GB HBM3,
#: 700.00 W; 7.7e-7 and 3.9e-7 on the CPU)
FT_CARD_ATOL = 1e-5


@pytest.mark.cuda
def test_ft_fit_over_data_ranks_of_the_card(card, monkeypatch):
    """FT-Transformer's fit (f32, TM_KERNEL_EXACT=1) with its rows
    sharded over 2 ranks of the card against one device, at learning
    rate 1e-3 where 20 AdamW steps keep the row sums' order at its own
    size (tests/test_torch_mesh2d.py): every step's gradient summed by
    the ring, the parameters and probabilities within FT_CARD_ATOL."""
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES as MF
    from transmogrifai_tpu_torch.models.base import tree_leaves, tree_map
    from transmogrifai_tpu_torch.parallel import spmd
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    fam = MF["FTTransformerClassifier"]
    for k, v in {"d_model": 16, "d_ff": 32, "n_steps": 20}.items():
        monkeypatch.setattr(fam, k, v)
    rng = np.random.default_rng(13)
    n, G = 4001, 2
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    w = (rng.random(n) > 0.33).astype(np.float32)
    hy = {"learningRate": torch.tensor([1e-3, 1e-3], device=card),
          "weightDecay": torch.tensor([0.0, 1e-4], device=card)}

    def fit(Xr, yr, wr):
        Xr, yr, wr = (torch.as_tensor(a).to(card) for a in (Xr, yr, wr))
        return fam.fit_batch(Xr.expand(G, -1, -1), yr.expand(G, -1),
                             wr.expand(G, -1), hy, 2)

    def flat(p):
        return torch.cat([t.reshape(G, -1) for t in tree_leaves(p)], 1)

    one = fit(X, y, w)
    mesh = par.data_mesh([card] * 2)
    xs, ys, ws = (par.shard_rows(a, mesh) for a in (X, y, w))
    before = tk.ring_allreduce.launches
    res = spmd.run_ranks(mesh, lambda r: fit(xs[r], ys[r], ws[r]), n)
    # two standardisation exchanges and one a step, one launch a rank
    assert tk.ring_allreduce.launches - before == 2 * (2 + 20)
    Xt = torch.from_numpy(X).to(card)
    for r, p in enumerate(res):
        gap = (flat(p) - flat(one)).abs().max().item()
        print(f"ft rank {r}: parameter gap {gap}")
        assert gap <= FT_CARD_ATOL, (r, gap)
    for g in range(G):
        pa, pb = (fam.predict_kernel(tree_map(lambda v: v[g], q), Xt, 2)
                  for q in (res[0], one))
        gap = (pa - pb).abs().max().item()
        print(f"ft item {g}: probability gap {gap}")
        assert gap <= FT_CARD_ATOL, (g, gap)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(12, 48, 896), (3, 5)])
def test_two_grid_rows_exchanges_in_flight_on_one_card(card, shape):
    """Each grid row of a 2 x 2 mesh of one card's ranks launches its
    exchange before either is read, so both are queued together (the
    ring chains them on the card): every rank's sum is bitwise the
    plain version's, and a third exchange of the first row after them
    too; no wait traps."""
    rng = np.random.default_rng(12)
    mesh = par.get_mesh_2d([card] * 4, grid_size=2)
    parts = [[torch.from_numpy(rng.integers(-64, 64, size=shape)
                               .astype(np.float32)).to(card)
              for _ in range(2)] for _ in range(3)]
    rows = [mesh.rows[0], mesh.rows[1], mesh.rows[0]]
    outs = [tk.ring_allreduce(p, row) for p, row in zip(parts, rows)]
    torch.cuda.synchronize()
    for p, out in zip(parts, outs):
        for o, want in zip(out, tk.ring_allreduce_torch(p)):
            assert torch.equal(o, want)


@pytest.mark.cuda
def test_checker_device_ranks_and_statistics_on_the_card(card, monkeypatch):
    """The SanityChecker's device average ranks on the card are bitwise
    the host ranks (ties included), so its statistics are bitwise alike
    under either rank switch; the contingency rows are exact counts."""
    from transmogrifai_tpu_torch.ops import sanity_checker as sc
    rng = np.random.default_rng(0)
    X = rng.normal(size=(20_000, 40)).astype(np.float32)
    X[rng.random(X.shape) < 0.4] = 0.5                 # heavy ties
    y = (rng.random(20_000) < 0.3).astype(np.float32)
    got = sc.rank_columns(torch.from_numpy(X).to(card)).cpu().numpy()
    assert np.array_equal(got, sc.host_rank_columns(X))
    monkeypatch.setenv("TM_CHECKER_HOST_RANKS", "0")
    dev = sc.compute_statistics(X, y, device=card)
    monkeypatch.setenv("TM_CHECKER_HOST_RANKS", "1")
    host = sc.compute_statistics(X, y, device=card)
    for k in dev:
        assert np.array_equal(dev[k], host[k], equal_nan=True), k
    cols = (X[:, :8] == 0.5).astype(np.float32)
    y_oh = np.stack([1.0 - y, y], axis=1).astype(np.float32)
    _, t = sc.cramers_v(cols, y_oh, device=card)
    assert np.array_equal(t, cols.T.astype(np.float64) @ y_oh)


@pytest.mark.cuda
def test_workflow_trains_and_scores_on_the_card(card, tmp_path):
    """A small workflow trained on the card stays there: the fitted
    model's tensors, the executor's fused impute block (bitwise the host
    transform), save/load onto the card and the fused scorer."""
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch.executor import _fused_transform
    from transmogrifai_tpu_torch.features import FeatureBuilder, types as ft
    from transmogrifai_tpu_torch.ops import SanityChecker, transmogrify
    from transmogrifai_tpu_torch.workflow import Workflow, WorkflowModel
    rng = np.random.default_rng(1)
    rows = [{"y": float(i % 2), "a": (None if rng.random() < 0.1 else
                                      float(rng.normal() + i % 2)),
             "b": float(rng.normal()), "c": "xyz"[int(rng.integers(0, 3))]}
            for i in range(600)]
    y = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
    xs = [FeatureBuilder.of(ft.Real, "a").from_column().as_predictor(),
          FeatureBuilder.of(ft.Real, "b").from_column().as_predictor(),
          FeatureBuilder.of(ft.PickList, "c").from_column().as_predictor()]
    checked = SanityChecker().set_input(y, transmogrify(xs)).output
    pred = TM.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=2, candidates=[["LogisticRegression", {"regParam": [0.1]}],
                               ["DecisionTreeClassifier", None]]
    ).set_input(y, checked).output
    model = Workflow([pred]).train(rows, device=card)
    assert model.selected_model().device.type == card.type
    # the pool threads share the card's stream: the serial executor
    # fits the same model bit for bit
    serial = Workflow([pred]).train(rows, device=card, executor="serial")
    for a, b in zip(model.stages, serial.stages):
        assert a.params == b.params
    for k, v in model.selected_model().model_params.items():
        assert torch.equal(v, serial.selected_model().model_params[k]), k
    timings = model.train_summaries["stageTimings"]["stages"]
    assert "fused" in {s["transform"] for s in timings}
    reals = [st for st in model.stages if type(st).__name__ ==
             "RealVectorizerModel"]
    ds = model.transform(rows)
    fused = _fused_transform(reals, ds, card)
    for st in reals:
        assert np.array_equal(fused[st.output.name],
                              st.transform(ds).column(st.output.name))
    walk = [r["probability_1"] for r in model.score(rows).column(pred.name)]
    model.save(str(tmp_path / "m"))
    loaded = WorkflowModel.load(str(tmp_path / "m"), device=card)
    assert loaded.selected_model().device.type == card.type
    again = [r["probability_1"] for r in loaded.score(rows).column(
        pred.name)]
    assert again == walk
    arr = loaded.compile_scoring(buckets=True).score_arrays(rows)[pred.name]
    np.testing.assert_allclose(arr[:, 1], walk, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the Criteo path on the card (no kernel of its own: torch gathers and
# deterministic scatter-adds)
# ---------------------------------------------------------------------------

def _ctr_rows(seed, n, K=26, d=13, B=1 << 16):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, B, (n, K)).astype(np.int32)
    idx[:, 0] = rng.integers(0, 50, n)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = ((idx[:, 0] % 3 == 0) ^ (rng.random(n) < 0.2)).astype(np.float32)
    return idx, X, y, B


@pytest.mark.cuda
def test_prefetch_survives_overwriting_its_source_chunk(card):
    """One host buffer, overwritten by the producer right after each
    yield while the card is busy on the consumer's stream: every chunk
    the consumer gets holds the values it had when it was yielded (the
    pinned staging copies it first), and its memory is not handed to a
    later copy while queued work still reads it."""
    from transmogrifai_tpu_torch.io.stream import prefetch_to_device
    buf = np.zeros(1 << 22, np.float32)

    def chunks():
        for i in range(6):
            buf[:] = i
            yield {"a": buf}
            buf[:] = -1.0           # the producer reuses its buffer

    sums = []
    big = torch.randn(4096, 4096, device=card)
    for c in prefetch_to_device(chunks(), buffer_size=2, device=card):
        for _ in range(3):
            big = big @ big / 64.0      # keep the consumer stream busy
        sums.append(c["a"].sum())
    torch.cuda.synchronize()
    assert [float(s) for s in sums] == [float(i * (1 << 22))
                                        for i in range(6)]


@pytest.mark.cuda
def test_sparse_epochs_run_without_a_host_sync(card):
    """Each family's sweep epoch (12 adagrad instances with l2 > 0, FTRL,
    the FM) and a single streamed-chunk epoch queue on the card with no
    host sync (``set_sync_debug_mode("error")`` raises on one)."""
    from transmogrifai_tpu_torch.models import sparse as S
    idx, X, y, B = _ctr_rows(0, 16384)
    it = torch.as_tensor(idx, device=card).long()
    Xt, yt = torch.as_tensor(X, device=card), torch.as_tensor(y, device=card)
    for fam in ("adagrad", "ftrl", "fm"):
        keys, init_state, advance, _, _ = S._family_sweep_def(fam, 8, 0)
        st = S._broadcast_state(init_state(B, 13, 0, None, card), 12)
        hb = tuple(torch.full((12,), 1e-2, device=card) for _ in keys)
        w = torch.ones(12, 16384, device=card)
        advance(st, hb, it, Xt, yt, w, 8192)       # first touch
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            advance(st, hb, it, Xt, yt, w, 8192)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    p = S.init_sparse_lr(B, 13, card)
    acc = S._zero_like_acc(p)
    torch.cuda.set_sync_debug_mode("error")
    try:
        S.sparse_lr_epoch(p, acc, it, Xt, yt, torch.ones(16384, device=card),
                          0.05, 1e-6, 8192)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(p["table"]).all()


@pytest.mark.cuda
def test_two_sparse_sweeps_are_bitwise_equal(card):
    """The default grid's sweep twice on the card: the same losses bit
    for bit (deterministic scatter-adds), the same winner, and a refit
    that reproduces its tables bit for bit."""
    from transmogrifai_tpu_torch.models import sparse as S
    idx, X, y, B = _ctr_rows(1, 40_000)
    grid = S.SparseModelSelector().params["grid"]
    a = S.validate_sparse_grid(idx, X, y, grid, B, device=card)
    b = S.validate_sparse_grid(idx, X, y, grid, B, device=card)
    assert a["logloss"] == b["logloss"] and a["best_index"] == b["best_index"]
    w = np.ones_like(y)
    f1 = S.fit_sparse_fm(idx, X, y, w, B, k=8, device=card)
    f2 = S.fit_sparse_fm(idx, X, y, w, B, k=8, device=card)
    for k in f1:
        np.testing.assert_array_equal(f1[k], f2[k])


@pytest.mark.cuda
def test_sparse_head_scores_a_row_alone_as_in_its_batch(card):
    """The binary head (LR and FM) on the card: each row scored alone
    equals its row of the batch bit for bit, and the card is within 1e-6
    of the CPU on the same parameters."""
    from transmogrifai_tpu_torch.models import sparse as S
    idx, X, y, B = _ctr_rows(2, 3000)
    w = np.ones_like(y)
    for params in (S.fit_sparse_lr(idx, X, y, w, B, epochs=1, device=card),
                   S.fit_sparse_fm(idx, X, y, w, B, k=8, epochs=1,
                                   device=card)):
        batch = S.predict_sparse_lr(params, idx, X, device=card)
        for i in (0, 1, 1234, 2999):
            one = S.predict_sparse_lr(params, idx[i:i + 1], X[i:i + 1],
                                      device=card)
            np.testing.assert_array_equal(one[0], batch[i])
        cpu = S.predict_sparse_lr(params, idx, X, device="cpu")
        np.testing.assert_allclose(batch, cpu, rtol=0, atol=1e-6)


def _lda_corpus(n=4000, V=128, k=6, seed=0):
    rng = np.random.default_rng(seed)
    topics = rng.dirichlet(np.full(V, 0.1), size=k)
    theta = rng.dirichlet(np.full(k, 0.3), size=n)
    return np.stack([rng.multinomial(40, theta[i] @ topics)
                     for i in range(n)]).astype(np.float32)


@pytest.mark.cuda
def test_fit_lda_queues_without_a_host_sync(card):
    """OpLDA's variational EM (30 EM x 20 E-steps) on the card: no host
    read inside the loops, the initial lambda uploaded pinned."""
    from transmogrifai_tpu_torch.ops import lda
    from transmogrifai_tpu_torch.workflow import to_device
    counts = to_device(_lda_corpus(), card)
    lda.fit_lda(counts, 6)                    # library handles, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lam = lda.fit_lda(counts, 6)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(lam).all()


@pytest.mark.cuda
def test_fit_lda_card_matches_cpu_within_the_lda_tolerance(card):
    """The card's fit against the CPU's from the same initial lambda:
    tests/test_torch_text_advanced.py's tolerance (rtol 1e-4 + 1e-6 of
    max|lambda|; topics rtol 1e-4 + atol 1e-6)."""
    from transmogrifai_tpu_torch.ops import lda
    counts = _lda_corpus()
    lam_cpu = lda.fit_lda(torch.from_numpy(counts), 6).numpy()
    lam_card = lda.fit_lda(torch.from_numpy(counts).to(card), 6).cpu()
    np.testing.assert_allclose(lam_card.numpy(), lam_cpu, rtol=1e-4,
                               atol=1e-6 * np.abs(lam_cpu).max())
    t_cpu = lda.infer_topics(torch.from_numpy(counts),
                             torch.from_numpy(lam_cpu)).numpy()
    t_card = lda.infer_topics(torch.from_numpy(counts).to(card),
                              torch.from_numpy(lam_cpu).to(card)).cpu()
    np.testing.assert_allclose(t_card.numpy(), t_cpu, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_inproc_fleet_on_the_card_launches_the_kernel(card, tmp_path):
    """Two inproc replicas sharing the card under a kill and a staged
    rollout (the smoke's inproc part, a second of traffic): no lost
    request, every answer within 1e-4 of numpy under its plane's policy
    and equal to the request scored alone through that plane, one fused
    kernel launch a fused bucket slice."""
    import chip_smoke
    root = str(tmp_path / "catalog")
    catalog = chip_smoke.write_catalog(root, 0)
    v2_path = str(tmp_path / "v2")
    v2 = (v2_path, chip_smoke.write_v2(v2_path, 0))
    out = chip_smoke.inproc_fleet_part(
        0, card, root, catalog, v2, replicas=2, rps=60.0, steady_s=0.8,
        failover_s=0.8, window_s=0.4, v2_requests=32)
    assert out["lost_requests"] == out["client_errors"] == 0
    assert out["kernel_launches"] == out["fused_slices"] > 0
    assert out["max_abs_err_vs_alone"] <= chip_smoke.FLEET_REF_ATOL


@pytest.mark.cuda
def test_socket_workers_on_the_card_launch_the_kernel(card, tmp_path):
    """Two socket workers on cuda:0 (each its own CUDA context) under a
    kill -9: every worker's status names the card and counts a fused
    launch a fused pass, no fallback, the restarted worker serves."""
    import chip_smoke
    root = str(tmp_path / "catalog")
    catalog = chip_smoke.write_catalog(root, 0)
    out = chip_smoke.socket_fleet_part(0, card, root, catalog, workers=2,
                                       rps=120.0, duration_s=2.0,
                                       window_s=0.5)
    assert out["lost_requests"] == out["client_errors"] == 0
    assert out["restarted_served"] > 0
    for w in out["per_worker"].values():
        assert torch.device(w["device"]).type == "cuda"
        assert w["launches"] == w["fused_batches"]


@pytest.mark.cuda
def test_worker_on_the_card_serves_a_saved_workflow(card, tmp_path):
    """``python -m transmogrifai_tpu_torch serve --engine`` on the card
    as a subprocess: every row within CLI_ATOL of WorkflowModel.score."""
    import chip_smoke
    import transmogrifai_tpu_torch as P
    ds = chip_smoke.wf_data(P.__name__, 600, 13)
    model = chip_smoke.wf_workflow().train(ds, device=card)
    out = chip_smoke.cli_part(model, chip_smoke.wf_data(P.__name__, 200, 17),
                              card, str(tmp_path), requests=8, replicas=2)
    assert out["ok"] == 8 and out["max_abs_err"] <= chip_smoke.CLI_ATOL


# ---------------------------------------------------------------------------
# the learned autotuner's launch choices (every candidate bitwise)
# ---------------------------------------------------------------------------

#: (G, n, d, S, m, B): small shapes with a ragged chunk of features (d
#: past a warp's 8), several sort chunks and a reduce grid the caps cut
TUNE_HIST_SHAPES = [(3, 5_000, 28, 5, 8, 32), (2, 3_001, 37, 3, 5, 40),
                    (1, 700, 3, 1, 1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TUNE_HIST_SHAPES)
@pytest.mark.parametrize("exact", ["0", "1"])
def test_every_histogram_candidate_is_bitwise_the_static_launch(
        card, shape, exact, monkeypatch):
    """Every config the autotuner's screen admits (sort chunk rows,
    reduce grid cap) gives bitwise the static launch's histogram, in
    both operand modes."""
    from transmogrifai_tpu_torch.autotune import candidate_configs
    from transmogrifai_tpu_torch.models import kernels as tk
    monkeypatch.setenv("TM_KERNEL_EXACT", exact)
    G, n, d, S, m, B = shape
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    bins = torch.randint(0, B, (n, d), generator=gen, device=card,
                         dtype=torch.int32)
    stats = torch.randn((G, n, S), generator=gen, device=card)
    pos = torch.randint(0, m, (G, n), generator=gen, device=card,
                        dtype=torch.int32)
    static = tk.histogram_grid(bins, stats, pos, m, B,
                               config=tk.STATIC_LAUNCH_CONFIG)
    cands = candidate_configs({"G": G, "n": n, "d": d, "B": B, "S": S,
                               "m": m}, max_block=1024)
    assert len(cands) > 1
    for cfg in cands:
        got = tk.histogram_grid(bins, stats, pos, m, B, config=cfg)
        assert torch.equal(got, static), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["prefix", "identity"])
@pytest.mark.parametrize("n", [1, 64, 5_000])
def test_every_scorer_candidate_is_bitwise_the_static_launch(card, form, n):
    """Every rows-a-block the screen admits gives bitwise the static
    launch's scores, and the screen's grid is the C entry's own."""
    import chip_smoke
    from transmogrifai_tpu_torch.autotune import serve_candidate_configs
    rng = np.random.default_rng(n)
    p, K, L = 22, 4, 1
    args = chip_smoke._serve_inputs(rng, form, n, 13, p, K, L, card)
    static = chip_smoke._serve_call(sk, form, args, sk.STATIC_LAUNCH_CONFIG)
    shape = {"K": K, "n": n, "p": p, "L": L}

    def grid(br):
        return sk.launch_blocks_on_card(card, n, p, K, L,
                                        tables=form == "prefix",
                                        block_rows=br)

    cands = serve_candidate_configs(shape, grid=grid)
    assert cands[0] == sk.STATIC_LAUNCH_CONFIG
    assert grid(0) == grid(8)               # 0 is the static rule
    grids = [grid(c["block_rows"]) for c in cands]
    assert len(set(grids)) == len(grids)
    for cfg in cands:
        assert torch.equal(chip_smoke._serve_call(sk, form, args, cfg),
                           static), cfg


@pytest.mark.cuda
def test_autotune_hooks_fire_once_a_shape_on_the_card(card, tmp_path,
                                                      monkeypatch):
    """With TM_AUTOTUNE=1 and both models, the histogram and the scorer
    consult their hooks on the card: one decision a distinct shape, the
    result bitwise the static launch's; unset, no decision."""
    import chip_smoke
    from transmogrifai_tpu_torch import autotune as at
    from transmogrifai_tpu_torch.models import kernels as tk
    hshape = {"G": 2, "n": 3_000, "d": 28, "B": 32, "S": 3, "m": 4}
    sshape = {"K": 4, "n": 64, "p": 22, "L": 1}
    kpath, spath = str(tmp_path / "k.json"), str(tmp_path / "s.json")
    at.KernelCostModel.fit(
        [{"shape": hshape, "config": c,
          "ms": 1.0 + 1e-4 * c["sort_chunk_rows"]}
         for c in at.candidate_configs(hshape)]).save(kpath)
    at.ServingCostModel.fit(
        [{"shape": sshape, "config": c, "ms": 0.01 + 1e-4 * c["block_rows"]}
         for c in at.serve_candidate_configs(sshape)]).save(spath)
    gen = torch.Generator(device=card).manual_seed(0)
    bins = torch.randint(0, 32, (3_000, 28), generator=gen, device=card,
                         dtype=torch.int32)
    stats = torch.randn((2, 3_000, 3), generator=gen, device=card)
    pos = torch.randint(0, 4, (2, 3_000), generator=gen, device=card,
                        dtype=torch.int32)
    args = chip_smoke._serve_inputs(np.random.default_rng(0), "prefix", 64,
                                    13, 22, 4, 1, card)
    for name in list(__import__("os").environ):
        if name.startswith("TM_AUTOTUNE"):
            monkeypatch.delenv(name)
    at.reset_autotuner()
    h0 = tk.histogram_grid(bins, stats, pos, 4, 32)
    s0 = chip_smoke._serve_call(sk, "prefix", args)
    assert at.kernel_dispatch_log() == [] == at.serving_dispatch_log()
    monkeypatch.setenv("TM_AUTOTUNE", "1")
    monkeypatch.setenv("TM_AUTOTUNE_MODEL", kpath)
    monkeypatch.setenv("TM_AUTOTUNE_SERVING_MODEL", spath)
    at.reset_autotuner()          # the knobs resolve once until a reset
    try:
        for _ in range(3):
            assert torch.equal(tk.histogram_grid(bins, stats, pos, 4, 32),
                               h0)
            assert torch.equal(chip_smoke._serve_call(sk, "prefix", args),
                               s0)
        hlog, slog = at.kernel_dispatch_log(), at.serving_dispatch_log()
        assert len(hlog) == 1 and hlog[0]["shape"] == hshape
        assert hlog[0]["config"]["sort_chunk_rows"] == 256
        assert len(slog) == 1 and slog[0]["config"] == {"block_rows": 8}
    finally:
        at.reset_autotuner()


# ---------------------------------------------------------------------------
# per-instance bins (TM_TREE_GRID_FOLD=0) and bf16 accumulation
# (TM_HIST_ACCUM_BF16=1) on the card
# ---------------------------------------------------------------------------

#: G, n, d, S, m, B, T (instances a bins slot serves when Gbins = G / T)
ITEM_SHAPES = [
    (16, 20_000, 28, 5, 8, 32, 1),       # the capture shape, rows cut
    (16, 9_001, 28, 3, 16, 32, 1),       # a GBT level of a sweep chunk
    (512, 3_000, 28, 5, 16, 32, 32),     # a chunk's deepest RF level
]


def _item_inputs(card, shape, gbins, integer, seed=0):
    G, n, d, S, m, B, _ = shape
    rng = np.random.default_rng(seed + n + gbins)
    bins = rng.integers(0, B, size=(gbins, n, d)).astype(np.int32)
    stats = (rng.integers(-3, 4, size=(G, n, S)) if integer
             else rng.normal(size=(G, n, S))).astype(np.float32)
    pos = rng.integers(0, m, size=(G, n)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(card) for a in (bins, stats, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ITEM_SHAPES, ids=str)
@pytest.mark.parametrize("slots", ["one", "per_tree_group", "per_instance"])
def test_per_instance_bins_launch_is_bitwise_the_plain_version(
        card, shape, slots, monkeypatch):
    """Exact mode, integer stats: one launch over Gbins in {1, G / T, G}
    bins slots equals the plain version bitwise; bf16 operands on float
    stats within 1e-4 of each cell's sum of |terms|."""
    G, T = shape[0], shape[6]
    gbins = {"one": 1, "per_tree_group": G // T, "per_instance": G}[slots]
    m, B = shape[4], shape[5]
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    bins, stats, pos = _item_inputs(card, shape, gbins, integer=True)
    before = tk.histogram_grid.launches
    got = tk.histogram_grid(bins, stats, pos, m, B)
    torch.cuda.synchronize()
    assert tk.histogram_grid.launches == before + 1
    assert torch.equal(got, tk.histogram_torch(bins, stats, pos, m, B))
    monkeypatch.setenv("TM_KERNEL_EXACT", "0")
    monkeypatch.setenv("TM_HIST_BF16", "1")
    bins, stats, pos = _item_inputs(card, shape, gbins, integer=False)
    got = tk.histogram_grid(bins, stats, pos, m, B)
    ref = tk.histogram_torch(bins, stats, pos, m, B)
    scale = tk.histogram_torch(bins, stats.abs(), pos, m, B)
    assert ((got - ref).abs() <= 1e-4 * scale + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HIST_SHAPES[:4])
def test_shared_bins_launch_unchanged_by_bins_slots(card, shape):
    """A shared-bins launch gives the same bits as (1, n, d) bins and as
    the same matrix in every instance's own slot: the slot only moves
    where an instance reads its bins, never its sums."""
    bins, stats, pos = _hist_inputs(card, shape, integer=False, seed=5)
    G, m, B = shape[0], shape[4], shape[5]
    shared = tk.histogram_grid(bins, stats, pos, m, B)
    assert torch.equal(tk.histogram_grid(bins[None], stats, pos, m, B),
                       shared)
    each = bins[None].expand(G, -1, -1).contiguous()
    assert torch.equal(tk.histogram_grid(each, stats, pos, m, B), shared)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HIST_SHAPES[:4])
def test_bf16_accumulation_on_the_card(card, shape, monkeypatch):
    """TM_HIST_ACCUM_BF16=1: the kernel and the plain version round at
    the same points (each node's runs, ``node_runs``). On integer stats
    in [0, 15] with most rows on one node, so that a node has several
    runs whose partials pass 256 (exact in f32, not in bf16), the
    kernel equals the plain version bitwise and differs from the f32
    histogram. On real stats the two differ only where a run's f32
    partial, summed in another order, rounds to another bf16 number:
    within two bf16 ulps (2^-6) of the cell's sum of |terms|, which
    bounds every running sum; both within the reference's bound of the
    f32 histogram (rtol 2e-2, atol 2.0). Exact mode wins."""
    G, n, d, S, m, B = shape
    monkeypatch.setenv("TM_KERNEL_EXACT", "0")
    monkeypatch.setenv("TM_HIST_ACCUM_BF16", "1")
    rng = np.random.default_rng(n)
    bins = torch.from_numpy(rng.integers(0, B, size=(n, d)).astype(
        np.int32)).to(card)
    pos = np.where(rng.random((G, n)) < 0.8, 0,
                   rng.integers(0, m, size=(G, n))).astype(np.int32)
    pos = torch.from_numpy(pos).to(card)
    assert int(tk.node_runs(pos, m, tk.run_rows_of(n)).max()) >= 1
    ints = torch.from_numpy(rng.integers(0, 16, size=(G, n, S)).astype(
        np.float32)).to(card)
    got = tk.histogram_grid(bins, ints, pos, m, B)
    assert torch.equal(got, tk.histogram_torch(bins, ints, pos, m, B))
    monkeypatch.setenv("TM_HIST_ACCUM_BF16", "0")
    assert not torch.equal(got, tk.histogram_torch(bins, ints, pos, m, B))
    pos = torch.from_numpy(rng.integers(0, m, size=(G, n)).astype(
        np.int32)).to(card)
    stats = torch.from_numpy(rng.normal(size=(G, n, S)).astype(
        np.float32)).to(card)
    f32 = tk.histogram_torch(bins, stats, pos, m, B)
    scale = tk.histogram_torch(bins, stats.abs(), pos, m, B)
    monkeypatch.setenv("TM_HIST_ACCUM_BF16", "1")
    got = tk.histogram_grid(bins, stats, pos, m, B)
    plain = tk.histogram_torch(bins, stats, pos, m, B)
    assert ((got - plain).abs() <= 2.0 ** -6 * scale + 1e-6).all()
    for h in (got, plain):
        assert torch.equal(h, h.to(torch.bfloat16).float())
        assert ((h - f32).abs() <= 2e-2 * f32.abs() + 2.0).all()
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    istats = torch.from_numpy(rng.integers(-3, 4, size=(G, n, S)).astype(
        np.float32)).to(card)
    assert torch.equal(tk.histogram_grid(bins, istats, pos, m, B),
                       tk.histogram_torch(bins, istats, pos, m, B))


@pytest.mark.cuda
def test_per_instance_selector_on_cuda_launches_per_chunk(card,
                                                          monkeypatch):
    """TM_TREE_GRID_FOLD=0 on the card: each family's sweep launches
    the kernel once a level a chunk of 16 items (its padded items
    included), the winner's refit once a level; DecisionTree's CV
    metrics in exact mode those of the same run on the CPU."""
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.features import types as ft
    from transmogrifai_tpu_torch.models.tuning import SWEEP_CHUNK
    monkeypatch.setenv("TM_TREE_GRID_FOLD", "0")
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    rng = np.random.default_rng(1)
    X = rng.normal(size=(3000, 6)).astype(np.float32)
    y = ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.float32)
    ds = Dataset({"y": y.astype(np.float64), "x": X},
                 {"y": ft.RealNN, "x": ft.OPVector})
    lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
    vec = FeatureBuilder.OPVector("x").from_column().as_predictor()
    names = ["DecisionTreeClassifier", "GBTClassifier"]

    def fit(device):
        sel = TM.BinaryClassificationModelSelector.with_cross_validation(
            candidates=names, device=device).set_input(lbl, vec)
        return sel.fit(ds)
    before = tk.histogram_grid.launches
    model = fit(None)
    launches = tk.histogram_grid.launches - before
    want = 0
    for res in model.summary["validationResults"]:
        fam = TM.MODEL_FAMILIES[res["family"]]
        items = 3 * len(res["grid"])
        want += -(-items // SWEEP_CHUNK["cuda"]) * fam.levels_per_fit()
    winner = TM.MODEL_FAMILIES[model.summary["bestModel"]["family"]]
    assert launches == want + winner.levels_per_fit()
    cpu = fit("cpu")
    for a, b in zip(model.summary["validationResults"],
                    cpu.summary["validationResults"]):
        if a["family"] == "DecisionTreeClassifier":
            np.testing.assert_allclose(a["gridMetrics"], b["gridMetrics"],
                                       atol=1e-6)
