"""The port's tree histogram (``transmogrifai_tpu_torch.models.kernels``)
against the JAX package's on the CPU: the plain PyTorch version against
vmapped ``histogram_xla`` and against the grid Pallas kernel in
interpret mode (``histogram_pallas_grid(..., double_buffer=False,
interpret=True)``, the BlockSpec path that still traces on this jax).
Integer-valued stats under ``TM_KERNEL_EXACT=1`` must agree bitwise
(integer sums are exact in f32 in any order); float stats within rtol
1e-5 / atol 1e-4, the JAX package's own histogram tolerance (f32 sums
in another order). Also the numerics policy, the launch plan that
keeps an instance's histogram independent of its batch, and the
wrapper's routing (the CUDA kernel itself runs in test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.models import kernels as jk
from transmogrifai_tpu_torch.models import kernels as tk
from transmogrifai_tpu_torch.models import serving_kernels as tsk


def _inputs(rng, G, n, d, S, m, B, integer):
    bins = rng.integers(0, B, size=(n, d)).astype(np.int32)
    if integer:
        stats = rng.integers(-3, 4, size=(G, n, S)).astype(np.float32)
    else:
        stats = rng.normal(size=(G, n, S)).astype(np.float32)
    pos = rng.integers(0, m, size=(G, n)).astype(np.int32)
    return bins, stats, pos


def _jax_xla(bins, stats, pos, m, B):
    return np.asarray(jax.vmap(
        lambda s, p: jk.histogram_xla(jnp.asarray(bins), s, p, m, B))(
            jnp.asarray(stats), jnp.asarray(pos)))


def _port(bins, stats, pos, m, B):
    return tk.histogram_grid(torch.from_numpy(bins), torch.from_numpy(stats),
                             torch.from_numpy(pos), m, B).numpy()


SHAPES = [  # G, n, d, S, m, B
    (1, 64, 3, 3, 1, 4),
    (3, 200, 5, 5, 4, 8),
    (4, 333, 7, 3, 8, 16),     # ragged n
    (2, 97, 4, 7, 2, 32),
]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_xla_bitwise_on_integer_stats_exact(shape,
                                                          monkeypatch):
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    G, n, d, S, m, B = shape
    bins, stats, pos = _inputs(np.random.default_rng(sum(shape)), *shape,
                               integer=True)
    got = _port(bins, stats, pos, m, B)
    assert got.shape == (G, m * S, d * B) and got.dtype == np.float32
    np.testing.assert_array_equal(got, _jax_xla(bins, stats, pos, m, B))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_xla_on_float_stats(shape):
    G, n, d, S, m, B = shape
    bins, stats, pos = _inputs(np.random.default_rng(7 + sum(shape)),
                               *shape, integer=False)
    np.testing.assert_allclose(_port(bins, stats, pos, m, B),
                               _jax_xla(bins, stats, pos, m, B),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("integer", [True, False])
def test_plain_matches_grid_pallas_interpret(shape, integer, monkeypatch):
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    G, n, d, S, m, B = shape
    bins, stats, pos = _inputs(np.random.default_rng(11 + sum(shape)),
                               *shape, integer=integer)
    ref = np.asarray(jk.histogram_pallas_grid(
        jnp.asarray(bins), jnp.asarray(stats), jnp.asarray(pos), m, B,
        double_buffer=False, interpret=True))
    got = _port(bins, stats, pos, m, B)
    if integer:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_bf16_operands_match_jax_bf16_policy(monkeypatch):
    """TM_HIST_BF16=1 rounds the masked stats to bf16 in both packages
    (the product with a 0/1 one-hot is exact, so only the f32 sum order
    differs)."""
    monkeypatch.setenv("TM_HIST_BF16", "1")
    bins, stats, pos = _inputs(np.random.default_rng(3), 3, 250, 6, 5, 4,
                               16, integer=False)
    got = _port(bins, stats, pos, 4, 16)
    np.testing.assert_allclose(got, _jax_xla(bins, stats, pos, 4, 16),
                               rtol=1e-5, atol=1e-4)
    # and it really rounded: f32 operands give another histogram
    monkeypatch.setenv("TM_HIST_BF16", "0")
    f32 = _port(bins, stats, pos, 4, 16)
    assert np.abs(got - f32).max() > 1e-4


def test_out_of_range_rows_and_bins_add_nothing(monkeypatch):
    """A node outside [0, m) or a bin outside [0, B) is an all-zero
    one-hot row in the JAX formulation."""
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    rng = np.random.default_rng(5)
    bins, stats, pos = _inputs(rng, 2, 120, 4, 3, 4, 8, integer=True)
    pos[0, :10] = 4
    pos[1, 10:20] = -1
    bins[20:30, 1] = 8
    bins[30:40, 2] = -1
    np.testing.assert_array_equal(_port(bins, stats, pos, 4, 8),
                                  _jax_xla(bins, stats, pos, 4, 8))


def test_wrapper_routes_cpu_to_plain_and_counts_only_kernel_launches():
    bins, stats, pos = _inputs(np.random.default_rng(9), 2, 50, 3, 3, 2, 4,
                               integer=True)
    before = tk.histogram_grid.launches
    got = _port(bins, stats, pos, 2, 4)
    ref = tk.histogram_torch(torch.from_numpy(bins), torch.from_numpy(stats),
                             torch.from_numpy(pos), 2, 4).numpy()
    np.testing.assert_array_equal(got, ref)
    assert tk.histogram_grid.launches == before


def test_wrapper_never_falls_back_off_cpu():
    bins = torch.empty((8, 2), dtype=torch.int32, device="meta")
    stats = torch.empty((1, 8, 3), device="meta")
    pos = torch.empty((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.histogram_grid(bins, stats, pos, 2, 4)


def test_wrapper_rejects_bad_input():
    bins = torch.zeros((8, 2), dtype=torch.int32)
    stats = torch.zeros((1, 8, 3))
    pos = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        tk.histogram_grid(bins.long(), stats, pos, 2, 4)
    with pytest.raises(TypeError, match="float32"):
        tk.histogram_grid(bins, stats.double(), pos, 2, 4)
    with pytest.raises(ValueError, match="row counts"):
        tk.histogram_grid(bins, stats[:, :4], pos, 2, 4)
    with pytest.raises(ValueError, match="want bins"):
        tk.histogram_grid(bins, stats[0], pos, 2, 4)


def test_numerics_policy(monkeypatch):
    for k in ("TM_KERNEL_EXACT", "TM_HIST_BF16", "TM_HIST_ACCUM_BF16"):
        monkeypatch.delenv(k, raising=False)
    assert tk.hist_dtype("cpu") == torch.float32
    assert tk.hist_dtype("cuda") == torch.bfloat16
    monkeypatch.setenv("TM_HIST_BF16", "1")
    assert tk.hist_dtype("cpu") == torch.bfloat16
    monkeypatch.setenv("TM_HIST_BF16", "0")
    assert tk.hist_dtype("cuda") == torch.float32
    monkeypatch.setenv("TM_HIST_BF16", "1")
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")
    assert tk.hist_dtype("cuda") == torch.float32
    # one exact-mode policy for serving and training
    assert tsk.kernel_exact is tk.kernel_exact
    assert tsk.serve_dtype("cuda") == torch.float32


def test_bf16_accumulation_is_not_ported(monkeypatch):
    monkeypatch.delenv("TM_KERNEL_EXACT", raising=False)
    monkeypatch.setenv("TM_HIST_ACCUM_BF16", "1")
    bins, stats, pos = _inputs(np.random.default_rng(1), 1, 16, 2, 3, 1, 4,
                               integer=True)
    with pytest.raises(NotImplementedError, match="TM_HIST_ACCUM_BF16"):
        _port(bins, stats, pos, 1, 4)
    monkeypatch.setenv("TM_KERNEL_EXACT", "1")      # exact mode wins
    _port(bins, stats, pos, 1, 4)


@pytest.mark.parametrize("knob", ["TM_PALLAS", "TM_HIST_DOUBLE_BUFFER",
                                  "TM_HIST_MXU_ALIGN",
                                  "TM_HIST_ROWS_PER_STEP"])
def test_tpu_only_knobs_change_nothing(knob, monkeypatch):
    bins, stats, pos = _inputs(np.random.default_rng(2), 2, 90, 3, 5, 2, 8,
                               integer=False)
    ref = _port(bins, stats, pos, 2, 8)
    monkeypatch.setenv(knob, "1" if knob != "TM_HIST_ROWS_PER_STEP" else "4")
    np.testing.assert_array_equal(_port(bins, stats, pos, 2, 8), ref)


@pytest.mark.parametrize("n", [1, 37, 4096, 4097, 200_000, 10_000_000])
def test_launch_plan_depends_on_rows_alone(n):
    """Runs and sort chunks (and so the order every cell sums in) come
    from n alone, never from the instance count; the run cap covers an
    instance whose every node ends in a partial run."""
    cuts = set()
    for G in (1, 16, 192):
        for S, m in ((5, 8), (3, 16), (3, 32), (5, 16), (5, 1)):
            p = tk.launch_plan(G, n, 28, S, m, 32)
            cuts.add((p["run_rows"], p["sort_chunk_rows"], p["sort_chunks"]))
            assert p["runs_cap"] == -(-n // p["run_rows"]) + m
            assert p["runs_cap"] <= tk.MAX_RUNS + m
            assert p["smem_bytes"] <= tk.SMEM_MAX_BYTES
            assert p["n_chunks"] * tk.FEATURES_PER_BLOCK >= 28
    assert len(cuts) == 1
    _, c, nch = cuts.pop()
    assert (nch - 1) * c < n <= nch * c


def test_launch_plan_at_the_training_shapes():
    # the histogram capture shape: one chunk of the 28 features, one bin
    # group (2 tiles of 16) and one stat group (5 of 8), so a block per
    # (instance, run slot); 7 warps of 4 features; three gathered
    # 128-row tiles (48 bytes of bins and 12 f32 stat words a row) and 8
    # tiles of row indices; the bins packed as a byte a bin, rows of 32
    # bytes, behind the sort's words
    p = tk.launch_plan(16, 200_000, 28, 5, 8, 32)
    assert p["n_chunks"] == 1 and p["bin_groups"] == 1
    assert p["stat_groups"] == 1 and p["warps"] == 7
    assert p["smem_bytes"] == 3 * 128 * (48 + 48) + 8 * 128 * 4
    assert p["smem_bytes"] <= tk.SMEM_MAX_BYTES
    assert p["runs_cap"] == 98 + 8 and p["sort_chunks"] == 196
    assert p["blocks"] == 16 * 106
    assert (p["dpad"], p["packed_bytes"]) == (32, 200_000 * 32)
    sort_words = 16 * (8 * 196 + 3 * 8 + 1 + 200_000)
    assert sort_words % 4 == 0
    assert p["workspace_words"] == sort_words + 200_000 * 32 // 4
    # 300 bins: ten groups of 32, each packed apart; the sort's words
    # rounded up to a 16-byte boundary first
    wide = tk.launch_plan(2, 1001, 13, 3, 4, 300)
    assert (wide["bin_groups"], wide["dpad"]) == (10, 16)
    assert wide["packed_bytes"] == 10 * 1001 * 16
    assert wide["workspace_words"] == (
        -(-2 * (4 + 12 + 1 + 1001) // 4) * 4 + 10 * 1001 * 16 // 4)
    assert p["partial_floats"] == 16 * 106 * 5 * 28 * 32
    # 100 features: four chunks; a narrow matrix still gets two warps
    assert tk.launch_plan(1, 1000, 100, 3, 4, 32)["n_chunks"] == 4
    assert tk.launch_plan(1, 1000, 100, 3, 4, 32)["warps"] == 8
    assert tk.launch_plan(1, 1000, 3, 3, 4, 32)["warps"] == 2
    # many bins or stats take more blocks, not more shared memory (the
    # earlier design's slab refused B = 512 at S = 5)
    wide = tk.launch_plan(1, 1000, 4, 21, 1, 512)
    assert (wide["bin_groups"], wide["stat_groups"]) == (16, 3)
    assert wide["blocks"] == wide["runs_cap"] * 16 * 3
    assert wide["smem_bytes"] == p["smem_bytes"]
    with pytest.raises(ValueError, match="grid"):
        tk.launch_plan(4096, 10_000_000, 4096, 64, 1, 4096)
    with pytest.raises(ValueError, match="nodes"):
        tk.launch_plan(1, 1000, 4, 5, tk.MAX_NODES + 1, 32)


def test_histogram_cost_counts_the_tensor_core_work():
    """At the capture shape the one-hot GEMM per node is 11.2 M mma of
    m16n8k16 (S = 5 padded to 8, B = 32 in two tiles), 45.9 GFLOP,
    against the 229 GFLOP of the one-hot GEMM over every node."""
    c = tk.histogram_cost(16, 200_000, 28, 5, 8, 32)
    assert c["mma"] == 16 * 12_500 * 28 * 2
    assert c["mma_flop"] == pytest.approx(45.9e9, rel=1e-3)
    assert tk.histogram_cost(1, 17, 28, 9, 1, 33)["mma"] == 2 * 28 * 3 * 2


def test_histogram_cost_at_the_capture_shape():
    """The bound the source note states: ~101 MB and 448 M adds at
    G=16 n=200k d=28 B=32 S=5 m=8, so ~30 us of bytes at 3.35 TB/s."""
    c = tk.histogram_cost(16, 200_000, 28, 5, 8, 32)
    assert c["adds"] == 16 * 200_000 * 28 * 5
    assert 101e6 < c["bytes"] < 102e6
    assert 29e-6 < c["bytes"] / 3.35e12 < 31e-6


def test_cuda_source_binds_what_the_wrapper_calls():
    import os
    from transmogrifai_tpu_torch import _cuda_build
    src = open(os.path.join(_cuda_build.CSRC_DIR,
                            tk.KERNEL_NAME + ".cu")).read()
    assert "extern \"C\" int tm_tree_histogram(" in src
    assert "tm_tree_histogram_error_string" in src
    assert "kernels.py" in src and "_hist_db_kernel" in src \
        and "_hist_grid_kernel" in src
