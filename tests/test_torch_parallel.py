"""The port's data-parallel layer (``transmogrifai_tpu_torch.parallel``
and the ring reductions of ``models.kernels``) against the JAX
package's on the CPU: the JAX side under the 8 forced host devices of
``tests/conftest.py``, the port on meshes of CPU ranks.

The JAX package's RDMA ring cannot trace on the installed jax (its
manual-DMA Pallas names are gone), so the port is held against JAX's
``psum`` path (``TM_MESH_RDMA_RING=0``) and its single-device calls.
On the CPU the port's ring wrappers run their plain version, the
origin-order sum the CUDA kernel is held to on the card
(``tests/test_torch_cuda.py``).

Tolerances, and why:
* integer-valued stats: bitwise (every partial sum is an exact f32
  integer, so no order of summation can differ);
* float stats: within 1e-6 of the sum of |terms| per cell (f32 sums of
  the same terms in another order: per shard, then across shards);
* the data-mesh grower against JAX's under shard_map and against the
  single call: rtol 1e-5, atol 1e-6, as the JAX package's own test
  (``test_grow_tree_grid_data_axis_matches_single_device``); the port's
  ranks against its own single grow: bitwise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from transmogrifai_tpu._jax_compat import shard_map
from transmogrifai_tpu.models import kernels as JK
from transmogrifai_tpu.models import trees as JT
from transmogrifai_tpu.parallel import data_parallel as JDP
from transmogrifai_tpu.parallel import mesh as JMESH
from transmogrifai_tpu_torch import parallel as TP
from transmogrifai_tpu_torch.models import kernels as TK
from transmogrifai_tpu_torch.models import trees as TT

_KNOBS = ("TM_MESH_DEVICES", "TM_MESH_AXIS", "TM_MESH_RDMA_RING",
          "TM_MESH_BOGUS")


@pytest.fixture
def clean_mesh_env(monkeypatch):
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TM_HIST_BF16", "0")
    return monkeypatch


def _jmesh(k):
    return JDP.data_mesh(jax.devices()[:k])


# ---------------------------------------------------------------------------
# TM_MESH_* strictness (mirrors test_sweep_scaling.test_mesh_config_strict)
# ---------------------------------------------------------------------------

MESH_ENVS = [
    ({}, None),
    ({"TM_MESH_DEVICES": "2"}, None),
    ({"TM_MESH_DEVICES": "8"}, None),
    ({"TM_MESH_DEVICES": "3"}, "does not divide"),
    ({"TM_MESH_DEVICES": "0"}, "does not divide"),
    ({"TM_MESH_DEVICES": "16"}, "does not divide"),
    ({"TM_MESH_DEVICES": "-1"}, "does not divide"),
    ({"TM_MESH_DEVICES": "junk"}, "bad value"),
    ({"TM_MESH_BOGUS": "1"}, "unknown mesh env var"),
    ({"TM_MESH_AXIS": "diagonal"}, "unknown TM_MESH_AXIS"),
    ({"TM_MESH_AXIS": "grid,data"}, None),
    ({"TM_MESH_RDMA_RING": "2"}, "bad value"),
    ({"TM_MESH_RDMA_RING": "1"}, None),
    ({"TM_MESH_RDMA_RING": "off"}, None),
]


@pytest.mark.parametrize("env,error", MESH_ENVS,
                         ids=lambda v: str(v) if v else "ok")
def test_mesh_config_strict(clean_mesh_env, env, error):
    """The same knobs parse to the same config, or raise the same error,
    in both packages; the port counts CUDA cards (8 here, as the JAX
    side's forced host devices)."""
    clean_mesh_env.setattr(torch.cuda, "device_count", lambda: 8)
    for k, v in env.items():
        clean_mesh_env.setenv(k, v)
    if error:
        for resolve in (JMESH.resolve_mesh_config, TP.resolve_mesh_config):
            with pytest.raises(ValueError, match=error):
                resolve()
        return
    j, t = JMESH.resolve_mesh_config(), TP.resolve_mesh_config()
    assert (j.devices, j.axis, j.rdma_ring) == (t.devices, t.axis,
                                                t.rdma_ring)


def test_mesh_config_overrides_and_ring_policy(clean_mesh_env):
    clean_mesh_env.setattr(torch.cuda, "device_count", lambda: 8)
    clean_mesh_env.setenv("TM_MESH_DEVICES", "2")
    assert TP.resolve_mesh_config(devices=1).devices == 1
    assert JMESH.resolve_mesh_config(devices=1).devices == 1
    # unset: the ring exactly on CUDA tensors (the JAX package: on TPU)
    assert TK.ring_reduce_enabled("cuda") and not TK.ring_reduce_enabled(
        "cpu")
    clean_mesh_env.setenv("TM_MESH_RDMA_RING", "0")
    assert not TK.ring_reduce_enabled("cuda")
    clean_mesh_env.setenv("TM_MESH_RDMA_RING", "1")
    assert TK.ring_reduce_enabled("cpu")


def test_no_card_means_no_default_mesh(clean_mesh_env):
    """With no card visible the default data mesh raises; it never
    falls back to the CPU. CPU ranks are asked for by name."""
    clean_mesh_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TP.data_mesh()
    mesh = TP.data_mesh(["cpu"] * 3)
    assert mesh.size == 3 and mesh.labels() == ["cpu:0", "cpu:1", "cpu:2"]
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        TP.Mesh(["cpu", "meta"])


def test_grid_data_axis_is_not_ported_in_the_selector(clean_mesh_env):
    """Which runner validates a family: the tree families fold, the
    linear ones sweep, whatever the mesh axis; TM_TREE_GRID_FOLD=0 (the
    per-instance path, ported) sends the trees through the sweep too."""
    from transmogrifai_tpu_torch.models import MODEL_FAMILIES
    from transmogrifai_tpu_torch.models.tuning import folds
    want = {"GBTClassifier": True, "LogisticRegression": False}
    for name, fold in want.items():
        assert folds(MODEL_FAMILIES[name]) is fold
    clean_mesh_env.setenv("TM_MESH_AXIS", "grid,data")
    for name, fold in want.items():
        assert folds(MODEL_FAMILIES[name]) is fold
    clean_mesh_env.setenv("TM_TREE_GRID_FOLD", "0")
    assert folds(MODEL_FAMILIES["LogisticRegression"]) is False
    assert folds(MODEL_FAMILIES["GBTClassifier"]) is False


@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("n,m", [(10, 4), (8, 4), (1, 3)])
def test_padding_helpers_match(mode, n, m):
    a = np.arange(n * 3, dtype=np.float32).reshape(n, 3) + 1
    jfn, tfn = ((JMESH.pad_to_multiple, TP.pad_to_multiple) if mode == "edge"
                else (JMESH.zero_pad_rows, TP.zero_pad_rows))
    want = np.asarray(jfn(a, m))
    assert np.array_equal(tfn(a, m), want)                 # numpy path
    assert np.array_equal(tfn(torch.from_numpy(a), m).numpy(), want)
    assert np.array_equal(
        tfn(torch.from_numpy(a.T.copy()), m, axis=1).numpy(),
        np.asarray(jfn(a.T.copy(), m, axis=1)))


def test_device_labels():
    assert TP.device_labels(["cpu", "cpu"]) == ["cpu:0", "cpu:1"]
    assert TP.device_labels([torch.device("cuda", 1), "cuda:0"]) == [
        "cuda:1", "cuda:0"]
    # ranks that share a card: one label each, the card's and the rank's
    assert TP.device_labels(["cuda:0"] * 4) == [
        "cuda:0#0", "cuda:0#1", "cuda:0#2", "cuda:0#3"]
    assert TP.device_labels(["cuda:0", "cuda:1", "cuda:0"]) == [
        "cuda:0#0", "cuda:1", "cuda:0#2"]
    labels = TP.device_labels(["cuda:0"] * 8)
    assert len(set(labels)) == 8


def test_shard_rows_pads_with_zero_rows():
    mesh = TP.data_mesh(["cpu"] * 4)
    a = np.arange(1, 11, dtype=np.float32).reshape(10, 1)
    sh = TP.shard_rows(a, mesh)
    assert [s.shape[0] for s in sh] == [3, 3, 3, 3]
    assert torch.equal(torch.cat(sh)[:10, 0], torch.arange(1, 11).float())
    assert torch.count_nonzero(torch.cat(sh)[10:]) == 0
    st = TP.shard_rows(np.ones((2, 10, 3), np.float32), mesh, axis=1)
    assert [tuple(s.shape) for s in st] == [(2, 3, 3)] * 4


# ---------------------------------------------------------------------------
# ring all-gather / all-reduce, plain version (mirrors :290)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 8])
def test_plain_ring_allgather_origin_order_on_every_rank(ndev):
    """Every rank's gathered (ndev, ...) stack is the parts in ORIGIN
    order, as JAX's ring delivers it; the port's all-reduce equals JAX's
    psum under shard_map on integer data, bitwise, and every rank's bits
    are the same."""
    x = np.arange(ndev * 2 * 128, dtype=np.float32).reshape(ndev * 2, 128)
    shards = x.reshape(ndev, 2, 128)
    mesh = TP.data_mesh(["cpu"] * ndev)
    parts = [torch.from_numpy(s.copy()) for s in shards]
    got = TK.ring_allgather(parts, mesh)
    for r in range(ndev):
        assert np.array_equal(got[r].numpy(), shards), r

    def body(xs):
        return JK.allreduce_data(xs, "data", ndev, use_ring=False)[None]

    jmesh = _jmesh(ndev)
    f = jax.jit(shard_map(body, mesh=jmesh, in_specs=P("data"),
                          out_specs=P("data"), check_vma=False))
    want = np.asarray(f(jnp.asarray(x))).reshape(ndev, 2, 128)
    red = TK.ring_allreduce(parts, mesh)
    for r in range(ndev):
        assert np.array_equal(red[r].numpy(), want[r])
        assert torch.equal(red[r], red[0])


def test_plain_ring_allreduce_is_the_origin_order_sum():
    """Float parts: the plain version sums left to right in origin
    order, on every rank alike (a permuted order would differ in the
    last bits of these values)."""
    rng = np.random.default_rng(3)
    parts = [torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32)
                              * 10.0 ** k) for k in range(4)]
    mesh = TP.data_mesh(["cpu"] * 4)
    red = TK.allreduce_data(parts, mesh)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert all(torch.equal(r, want) for r in red)
    assert TK.allreduce_data(parts[:1], TP.data_mesh(["cpu"]))[0] is parts[0]
    with pytest.raises(TypeError, match="float32 only"):
        TK.ring_allreduce([p.double() for p in parts], mesh)
    with pytest.raises(ValueError, match="parts for a mesh"):
        TK.ring_allreduce(parts[:3], mesh)


def test_ring_plan_and_cost():
    """An all-reduce gives each rank a 16-byte-aligned partition that
    its blocks cover exactly once, and the partitions cover every
    element; an all-gather gives each rank its whole part. Blocks stay
    within one wave over all ranks."""
    for numel, ndev in [(573_440, 4), (516_096, 2), (1, 3), (4097, 8),
                        (7, 8)]:
        for gather in (False, True):
            plan = TK.ring_plan(numel, ndev, gather=gather)
            share = numel if gather else plan["part"]
            assert plan["blocks"] * ndev <= TK.RING_WAVE_BLOCKS
            assert plan["chunk"] % 4 == 0
            assert (plan["blocks"] - 1) * plan["chunk"] < share <= (
                plan["blocks"] * plan["chunk"])
            if not gather:
                assert plan["part"] % 4 == 0
                assert (ndev - 1) * plan["part"] < numel + 4 * ndev
                assert ndev * plan["part"] >= numel
    assert TK.ring_plan(573_440, 4)["part"] == 573_440 // 4
    assert TK.ring_plan(0, 4)["blocks"] == 0
    cost = TK.ring_cost(4, 573_440, same_card=True)
    assert cost["bytes"] == 8.0 * 4 * 573_440
    # the exchange moves exactly the bound's bytes on one card
    assert cost["moved_bytes"] == cost["bytes"]
    assert cost["bound_by"] == "bytes"
    assert cost["bound_ms"] == pytest.approx(cost["bytes"] / 3.35e12 * 1e3)
    peer = TK.ring_cost(4, 573_440, same_card=False)
    assert peer["bound_ms"] == pytest.approx(
        4.0 * 573_440 * 2 * 3 / 4 / 450e9 * 1e3)


def test_peer_pairs_are_every_ordered_pair_of_distinct_cards():
    """The exchange reads and writes every rank from every rank, so peer
    access is needed between every pair of distinct cards, not only
    neighbours; ranks sharing a card need none."""
    cards = [torch.device("cuda", i) for i in (0, 1, 2, 3)]
    pairs = TK.peer_pairs(cards)
    assert len(pairs) == 12 and len(set(pairs)) == 12
    assert (cards[0], cards[2]) in pairs and (cards[2], cards[0]) in pairs
    assert TK.peer_pairs([torch.device("cuda", 0)] * 4) == []
    assert TK.peer_pairs(["cuda:0", "cuda:1", "cuda:0"]) == [
        (cards[0], cards[1]), (cards[1], cards[0])]


# ---------------------------------------------------------------------------
# sharded_histograms (mirrors :261)
# ---------------------------------------------------------------------------

def _hist_inputs(rng, n, integer, d=5, B=8, m=4, G=3, S=5):
    bins = rng.integers(0, B, (n, d)).astype(np.int32)
    stats = (rng.integers(0, 5, (G, n, S)) if integer
             else rng.normal(size=(G, n, S))).astype(np.float32)
    pos = rng.integers(0, m, (G, n)).astype(np.int32)
    return bins, stats, pos, m, B


def _jax_single(bins, stats, pos, m, B):
    return np.asarray(jax.jit(jax.vmap(
        lambda s, p: JK.histogram_xla(jnp.asarray(bins), s, p, m, B)))(
            jnp.asarray(stats), jnp.asarray(pos)))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n", [264, 263])
@pytest.mark.parametrize("ndev", [1, 3, 4, 8])
def test_sharded_histograms_match_jax(clean_mesh_env, integer, n, ndev):
    rng = np.random.default_rng(n + ndev)
    bins, stats, pos, m, B = _hist_inputs(rng, n, integer)
    clean_mesh_env.setenv("TM_MESH_RDMA_RING", "0")        # JAX: psum
    jps = JDP.sharded_histograms(bins, stats, pos, m, B, mesh=_jmesh(ndev))
    single = _jax_single(bins, stats, pos, m, B)
    scale = _jax_single(bins, np.abs(stats), pos, m, B)
    mesh = TP.data_mesh(["cpu"] * ndev)
    for ring in ("1", "0"):
        clean_mesh_env.setenv("TM_MESH_RDMA_RING", ring)
        got = TP.sharded_histograms(bins, stats, pos, m, B, mesh=mesh)
        assert got.shape == single.shape
        for want in (jps, single):
            if integer:
                assert np.array_equal(got, want), ring
            else:
                assert (np.abs(got - want) <= 1e-6 * scale + 1e-7).all()


# ---------------------------------------------------------------------------
# grow_tree_grid over a data mesh (mirrors :320)
# ---------------------------------------------------------------------------

def _grow_case(rng, n=320, d=5, Gb=3):
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    w = (rng.random((Gb, n)) < 0.8).astype(np.float32)
    bins, edges = JT._prep(jnp.asarray(X), 8, jnp.ones(n, np.float32))
    gw = (y[None, :, None] * w[..., None]).astype(np.float32)
    hw = np.broadcast_to(w[..., None], gw.shape).astype(np.float32)
    fixed = dict(feat_mask=np.ones((Gb, d), np.float32),
                 lam=np.full((Gb,), 1e-6, np.float32),
                 gamma=np.zeros((Gb,), np.float32),
                 min_instances=np.ones((Gb,), np.float32),
                 depth_limit=np.full((Gb,), 3.0, np.float32))
    return np.array(bins), np.array(edges), gw, hw, w, fixed


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_grow_tree_grid_data_mesh_matches_jax(clean_mesh_env, ndev):
    rng = np.random.default_rng(ndev)
    bins, edges, gw, hw, w, fixed = _grow_case(rng)
    jfix = {k: jnp.asarray(v) for k, v in fixed.items()}
    jedges = jnp.asarray(edges)

    def jgrow(b, g, h, ww, **kw):
        return JT.grow_tree_grid(
            b, g, h, ww, jedges, jfix["feat_mask"], jfix["lam"],
            jfix["gamma"], jfix["min_instances"], jfix["depth_limit"],
            max_depth=3, **kw)[:4]

    jargs = tuple(jnp.asarray(a) for a in (bins, gw, hw, w))
    single = jax.jit(jgrow)(*jargs)
    f = jax.jit(shard_map(
        lambda b, g, h, ww: jgrow(b, g, h, ww, data_axis="data",
                                  data_axis_size=ndev, data_ring=False),
        mesh=_jmesh(ndev),
        in_specs=(P("data"), P(None, "data"), P(None, "data"),
                  P(None, "data")),
        out_specs=P(), check_vma=False))
    jdp = f(*jargs)

    t = {k: torch.from_numpy(np.array(v)) for k, v in
         dict(bins=bins, gw=gw, hw=hw, w=w).items()}
    rep = [torch.from_numpy(edges)] + [torch.from_numpy(fixed[k]) for k in
                                       ("feat_mask", "lam", "gamma",
                                        "min_instances", "depth_limit")]
    tsingle = TT.grow_tree_grid(t["bins"], t["gw"], t["hw"], t["w"], *rep,
                                max_depth=3)
    mesh = TP.data_mesh(["cpu"] * ndev)
    for ring in (True, False):
        out = TT.grow_tree_grid(
            TP.shard_rows(t["bins"], mesh), TP.shard_rows(t["gw"], mesh, 1),
            TP.shard_rows(t["hw"], mesh, 1), TP.shard_rows(t["w"], mesh, 1),
            *rep, max_depth=3, mesh=mesh, data_ring=ring)
        assert len(out) == ndev
        for res in out:
            for name, a, b, c, got in zip(("feat", "thr", "leaf", "gains"),
                                          single, jdp, tsingle, res):
                for want in (a, b):
                    np.testing.assert_allclose(
                        got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6,
                        err_msg=f"{name} ring={ring}")
                assert torch.equal(got, c), name


def test_grow_tree_grid_data_mesh_ragged_rows_and_subsets(clean_mesh_env):
    """A row count no mesh size divides (zero-padded shards) and the
    per-node column-subset path: every rank bitwise the port's single
    grow."""
    rng = np.random.default_rng(11)
    n, d, Gb = 301, 6, 4
    X = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    y = (X[:, 0] * X[:, 1] > 0).float()
    w = torch.from_numpy((rng.random((Gb, n)) < 0.7).astype(np.float32))
    bins, edges = TT._prep(X, 16, torch.ones(n))
    gw = ((0.5 - y)[None, :, None] * w[..., None]).contiguous()
    hw = (0.25 * w[..., None]).contiguous()
    draws = [torch.from_numpy(rng.random((Gb, 1 << lv, d)).astype(
        np.float32)) for lv in range(4)]
    rate = torch.full((Gb,), 0.6)
    rep = (edges, torch.ones((Gb, d)), torch.full((Gb,), 1.0),
           torch.zeros(Gb), torch.full((Gb,), 2.0), torch.full((Gb,), 4.0))
    single = TT.grow_tree_grid(bins, gw, hw, w, *rep, draws, rate,
                               max_depth=4)
    mesh = TP.data_mesh(["cpu"] * 3)
    out = TT.grow_tree_grid(TP.shard_rows(bins, mesh),
                            TP.shard_rows(gw, mesh, 1),
                            TP.shard_rows(hw, mesh, 1),
                            TP.shard_rows(w, mesh, 1), *rep, draws, rate,
                            max_depth=4, mesh=mesh)
    for res in out:
        for a, b in zip(single[:4], res[:4]):
            assert torch.equal(a, b)
    pos = torch.cat([res[4] for res in out], dim=1)[:, :n]
    assert torch.equal(pos, single[4])


# ---------------------------------------------------------------------------
# sharded_contingency and sharded_score
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 3, 8])
def test_sharded_contingency_matches_jax(ndev):
    rng = np.random.default_rng(ndev)
    n = 203
    g = np.eye(6, dtype=np.float32)[rng.integers(0, 6, n)]
    yo = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    want = np.asarray(JDP.sharded_contingency(g, yo, mesh=_jmesh(ndev)))
    got = TP.sharded_contingency(g, yo, mesh=TP.data_mesh(["cpu"] * ndev))
    assert np.array_equal(got, want)
    assert np.array_equal(got, g.T @ yo)


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_score_matches_jax(ndev):
    """A decision tree fitted by the JAX package, its params carried to
    the port, scored over row shards in both packages."""
    from transmogrifai_tpu import models as JM
    from transmogrifai_tpu_torch import models as TM
    rng = np.random.default_rng(ndev)
    n, d = 203, 4
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.float32)
    jfam = JM.MODEL_FAMILIES["DecisionTreeClassifier"]
    tfam = TM.MODEL_FAMILIES["DecisionTreeClassifier"]
    params = jfam.fit_kernel(jnp.asarray(X), jnp.asarray(y),
                             jnp.ones(n, jnp.float32), {"maxDepth": 3.0}, 2)
    want = np.asarray(JDP.sharded_score(jfam.predict_kernel, params, X,
                                        mesh=_jmesh(ndev)))
    tparams = TM.params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, "cpu")
    got = TP.sharded_score(tfam.predict_kernel, tparams, X,
                           mesh=TP.data_mesh(["cpu"] * ndev))
    assert got.shape == want.shape == (n, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
