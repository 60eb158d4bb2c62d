"""chip_smoke.py's training phase on the CPU: the binary selector over
its default candidate list (the four tree families and LinearSVC,
LogisticRegression, NaiveBayes) at default grids and registered caps,
on 3,000 of its HIGGS-shaped rows. Holds the script's own checks
(winner against the linear yardstick, the scored column, the
exact-mode decision tree bitwise and GBT per grid point, here CPU
against CPU) and the launch count it derives from the code, which the
CPU path does not move. And the GBT check against planted histogram
faults (gbt_parity_probe.py's arms), CPU against CPU: each must part
the trees at a split that is no near tie. Then the linear phase (the
oracle, card-vs-CPU here CPU against CPU, the invariance) and the
multiclass and regression default lists at small sizes.
"""
import pytest
import torch

import chip_smoke
import gbt_parity_probe
from transmogrifai_tpu_torch import models as TM
from transmogrifai_tpu_torch.models import kernels as tk


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs: the suite runs several
    workers at once, and torch's intra-op threads on these small tensors
    only add contention (half the CPU time of the default threads here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_training_phase_runs_on_the_cpu():
    tk.histogram_grid.launches = 0
    out = chip_smoke.training_phase(0, rows=3000, device="cpu")
    assert out["histogram_launches"] == 0      # the CPU path counts nothing
    # a level per launch: DT, RF (its 32 trees share each launch), GBT's
    # 24 rounds, XGBoost's 24 rounds at depth 6 (274), then the refit
    assert out["expected_launches"] == (
        5 + 5 + 5 * 24 + 6 * 24
        + TM.MODEL_FAMILIES[out["winner"]].levels_per_fit())
    assert out["winner"] in chip_smoke.TREE_FAMILIES
    assert out["holdout_auroc"] >= out["linear_holdout_auroc"] + 0.1
    families = set(chip_smoke.TREE_FAMILIES + chip_smoke.LINEAR_FAMILIES)
    assert set(out["families"]) == families
    assert set(out["family_wall_s"]) == families
    assert "linear_family_device" not in out       # the profiler: CUDA only
    assert out["dt_exact_feat_thr_bitwise"]
    assert out["gbt_metric_max_diff"] == 0.0
    assert out["gbt_gain_gap_max"] == 0.0
    assert out["gbt_hist_diff_max"] == 0.0
    assert out["gbt_divergence"] == [None] * 4     # one fit a grid point


@pytest.fixture(scope="module")
def gbt_reference():
    X, y = chip_smoke.training_data(0, 2000)
    return X, y, chip_smoke.gbt_side(X, y, "cpu", {"TM_KERNEL_EXACT": "1"})


@pytest.mark.parametrize("arm", ["bf16", "drop_row"])
def test_gbt_check_flags_a_planted_histogram_fault(gbt_reference, arm):
    X, y, ref = gbt_reference
    knobs, fault = gbt_parity_probe.ARMS[arm]
    out = chip_smoke.gbt_compare(
        chip_smoke.gbt_side(X, y, "cpu", knobs, fault), ref, X)
    assert out["gain_gap_max"] > chip_smoke.GBT_GAP_RTOL
    first = [d for d in out["divergence"] if d]
    assert first and all(d["hist_rel_diff"] > chip_smoke.GBT_HIST_RTOL
                         for d in first)


def test_linear_phase_runs_on_the_cpu():
    """The linear phase at a small size on the CPU: the oracle within
    its limits, every grid point CPU against CPU equal, the candidate
    alone and stacked bitwise; the no-sync check is CUDA only."""
    out = chip_smoke.linear_phase(0, rows=4000, parity_rows=1500,
                                  device="cpu")
    for kind, limit in chip_smoke.ORACLE_RTOL.items():
        assert out[f"oracle_{kind}_rel_err"] <= limit
    assert set(out["card_vs_cpu_max_gap"]) == {
        "binary/LinearSVC", "binary/LogisticRegression", "binary/NaiveBayes",
        "multiclass/LogisticRegression"}
    assert set(out["card_vs_cpu_max_gap"].values()) == {0.0}
    assert out["invariance_bitwise"]
    assert "no_sync_dispatch_s" not in out


def test_oracle_limit_separates_a_wrong_penalty():
    """The oracle's limit is far below what a wrong penalty moves: the
    numpy logistic fit at regParam 0.02 against 0.01, and ridge alike,
    differ by more than ten times ORACLE_RTOL."""
    import numpy as np
    X, z = chip_smoke.training_signal(0, 3000)
    Xb = np.concatenate([X, np.ones((len(X), 1), np.float32)],
                        1).astype(np.float64)
    w = np.ones(len(X))
    for kind, fit, y in (("logistic", chip_smoke._np_logistic,
                          (z > 0).astype(np.float64)),
                         ("ridge", chip_smoke._np_ridge, z)):
        a, b = fit(Xb, y, w, 0.01), fit(Xb, y, w, 0.02)
        assert (np.abs(a - b).max() / np.abs(a).max()
                > 10 * chip_smoke.ORACLE_RTOL[kind])


def test_other_lists_phase_runs_on_the_cpu():
    """The multiclass and regression default lists at 2,000 rows: every
    family validated, a winner, a finite refit; the CPU launches no
    kernel."""
    out = chip_smoke.other_lists_phase(0, rows=2000, device="cpu")
    assert "GeneralizedLinearRegression" in out["regression"]["families"]
    assert "NaiveBayes" in out["multiclass"]["families"]
    for problem in ("multiclass", "regression"):
        o = out[problem]
        assert set(o["family_wall_s"]) == set(o["families"])
        assert o["winner"] in o["families"]
        assert o["histogram_launches"] == 0 < o["expected_launches"]


def test_ring_phase_runs_on_the_cpu():
    """The ring_kernel phase on CPU ranks (2, 3, 4) at a small shape:
    the plain version against itself, the gather in origin order, the
    back-to-back calls; no timings off the card."""
    rows = chip_smoke.ring_phase(0, device="cpu", repeats=3,
                                 shapes=[("small", (3, 5, 7))])
    assert [r["ndev"] for r in rows] == list(chip_smoke.RING_RANKS)
    for r in rows:
        assert r["bitwise"] and r["max_abs_err"] == 0.0
        assert r["plan"]["blocks"] * r["ndev"] <= tk.RING_WAVE_BLOCKS
        assert r["bound_by"] == "bytes" and "ms" not in r


def test_data_parallel_phase_runs_on_the_cpu():
    """The data_parallel phase on 4 CPU ranks over 3,001 rows (ragged
    shards): every rank's trees bitwise the single grow's and
    sharded_histograms bitwise histogram_grid; the CPU path launches
    no kernel, so both counts stay 0."""
    out = chip_smoke.data_parallel_phase(0, rows=3001, device="cpu")
    assert out["trees_bitwise"] and out["sharded_histograms_bitwise"]
    assert out["ranks"] == chip_smoke.DP_RANKS and out["Gb"] == 12
    assert out["ring_launches"] == out["expected_ring_launches"] == 0
    assert out["histogram_launches"] == 0
    assert "device_busy_share" not in out


def test_sass_opcode_count_reads_cuobjdump_lines():
    """The smoke's tensor-core check: an opcode counts where it is the
    instruction (after the address, or after a predicate), never in the
    encoding comment or a function header."""
    import chip_smoke
    sass = "\n".join([
        "        Function : _Z13tree_hist_mmaILb0EEvPKh",
        "        /*0150*/                   HMMA.16816.F32.BF16 R4, R8, "
        "R12, R4 ;              /* 0x00000000a7387233 */",
        "        /*0160*/               @P0 HMMA.16816.F32.BF16 R16, R8, "
        "R12, R16 ;   /* 0x00000000a7387233 */",
        "        /*0170*/                   HSET2.BF16_V2.BF.EQ.AND R56, R1, "
        "R0, PT ;  /* 0x00000000a7387233 */",
        "                                                  /* 0x000fe20000000f00 */",
        "        /*0180*/                   MOV R2, 0x1 ;   /* HMMA in a comment */",
    ])
    assert chip_smoke.sass_opcode_count(sass, "HMMA") == 2
    assert chip_smoke.sass_opcode_count(sass, "HSET2") == 1
    assert chip_smoke.sass_opcode_count("", "HMMA") == 0


def test_kernels_line_takes_every_number_from_the_run():
    """Each kernel entry carries the contract's keys, and every number in
    the line is one of the run's own phase results (no constant)."""
    import itertools
    seen = set()
    count = itertools.count(1)

    def num():
        v = next(count) + 0.5
        seen.add(v)
        return v

    def row(**extra):
        r = {k: num() for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                "max_abs_err", "call_ms", "plain_call_ms",
                                "library_call_ms", "span_ms",
                                "library_device_ms")}
        r.update(bound_by="bytes", **extra)
        return r

    rows = [row(form="identity", shape=[64, 22, 4, 1], dtype="bfloat16"),
            row(form="prefix", shape=[64, 13, 22, 4, 1], act="sigmoid_pair",
                dtype="bfloat16"), row(form="prefix")]
    hrows = [row(dtype="bfloat16", **{k: num() for k in "GndSmB"}), row()]
    rrows = [row(layout="one card", shape="gbt_level", ndev=n,
                 dims=[12, 48, 896]) for n in (2, chip_smoke.DP_RANKS)]
    counts = {"kernel_launches": num(), "histogram_launches": num(),
              "ring_launches": num(), "hmma": num(), "empty": num()}
    line = chip_smoke.kernels_line(
        rows, {"kernel_launches": counts["kernel_launches"]},
        counts["empty"], hrows,
        {"histogram_launches": counts["histogram_launches"]},
        counts["hmma"], rrows, {"ring_launches": counts["ring_launches"]})
    contract = {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"}
    names = []
    for k in line["kernels"]:
        names.append(k["name"])
        assert contract <= set(k)
        assert k["route"] == "cuda"
        for key, v in k.items():
            for x in (v if isinstance(v, list) else [v]):
                if isinstance(x, float):
                    assert x in seen, (k["name"], key, x)
    assert names == ["fused_linear_scores", "tree_histogram",
                     "ring_allreduce"]
    assert line["kernels"][2]["ndev"] == chip_smoke.DP_RANKS
    fused = line["kernels"][0]
    assert fused["shape"] == [64, 13, 22, 4, 1]    # the prefix form's row
    assert fused["identity_shape"] == [64, 22, 4, 1]
    assert "serving/fusion.py:265" in fused["replaces"]


@pytest.fixture(scope="module")
def workflow_run():
    """The workflow phase on the CPU: Titanic (card vs CPU here CPU
    against CPU), the CSV workflow at 1,000 rows, the export and serve."""
    return chip_smoke.workflow_phase(0, device="cpu", rows=1000)


def test_workflow_phase_runs_on_the_cpu(workflow_run):
    wf = workflow_run
    ti, sc, ex = wf["titanic"], wf["scale"], wf["export"]
    assert wf["native_csv"] in (True, False)
    assert ti["train_auroc"] > 0.75
    assert ti["winner"] == {"family": "LogisticRegression",
                            "hyper": {"regParam": 0.01,
                                      "elasticNetParam": 0.5}}
    assert ti["loaded_scores_bitwise"] and ti["kept_slots"] > 0
    # the CPU path counts no launch
    assert wf["histogram_launches"] == ti["histogram_launches"] == 0
    assert sc["rows"] == 1000 and sc["loaded_scores_bitwise"]
    assert sc["features_in"] == 2 * 30 + 2 + sum(
        min(k, 20) + 2 for k in chip_smoke.SCALE_LEVELS)
    assert sc["local_max_abs_err"] <= chip_smoke.LOCAL_ATOL
    assert sc["checker_oracle"]["ranks_exact"]
    assert ex["fused_fallbacks"] == 0 and ex["fused_batches"] > 0
    assert sum(ex["matched"].values()) == ex["requests"]
    assert ex["max_abs_err"] <= chip_smoke.SERVE_ATOL


def test_workflow_lines_take_every_number_from_the_run(workflow_run):
    import json
    import re

    def numbers(v):
        if isinstance(v, dict):
            return [x for u in v.values() for x in numbers(u)]
        if isinstance(v, (list, tuple)):
            return [x for u in v for x in numbers(u)]
        return [v] if isinstance(v, float) else []

    seen = set(numbers(workflow_run))
    lines = chip_smoke.workflow_lines(workflow_run)
    assert len(lines) >= 12
    for line in lines:
        body = line.split(": ", 2)[-1]
        if body.startswith("{"):
            vals = numbers(json.loads(body))
        else:
            vals = [float(x) for x in re.findall(
                r"[-+]?\d+\.\d+(?:e[-+]?\d+)?", body)]
        assert vals, line
        for v in vals:
            assert v in seen, (line, v)


@pytest.fixture(scope="module")
def titanic_pair():
    """The Titanic workflow fitted twice in exact mode on the CPU: the
    comparison's two sides (card against CPU here CPU against CPU)."""
    from transmogrifai_tpu_torch.readers import DataReaders
    reader = DataReaders.csv(chip_smoke._repo_file(
        "examples", "data", "titanic.csv"),
        chip_smoke._types(chip_smoke.TITANIC_SCHEMA), key="id")
    with chip_smoke.env(TM_KERNEL_EXACT="1"):
        return (chip_smoke._titanic_workflow().train(reader, device="cpu"),
                chip_smoke._titanic_workflow().train(reader, device="cpu"),
                reader)


@pytest.mark.parametrize("family,match", [
    (None, None),
    ("LogisticRegression", "LogisticRegression CV"),
    ("GBTClassifier", "GBT metrics recomputed on the card")])
def test_titanic_check_flags_a_planted_cv_gap(titanic_pair, family, match):
    """The two sides agree; a planted gap of 1e-3 in one grid point of
    the card's summary makes the comparison raise: LR's past 1e-4 at
    once; GBT's sends it to the near-tie analysis, whose recomputed
    metrics are not the (planted) workflow's."""
    card, cpu, reader = titanic_pair

    def plant(summary):
        r = next(r for r in summary["validationResults"]
                 if r["family"] == family)
        r["gridMetrics"][0] += 1e-3
    if family is None:
        out = chip_smoke.titanic_compare(card, cpu, reader, "cpu")
        assert out["exact_card_vs_cpu_cv_gap"]["GBTClassifier"] == 0.0
        assert out["exact_gbt_divergence"] is None
        return
    with pytest.raises(AssertionError, match=match):
        chip_smoke.titanic_compare(card, cpu, reader, "cpu", check=plant)
    # the plant went into a copy: the fitted summaries are untouched
    assert chip_smoke.titanic_compare(card, cpu, reader, "cpu")


def test_checker_oracle_flags_planted_statistics():
    import numpy as np
    from transmogrifai_tpu_torch.ops import sanity_checker as sc
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 6)).astype(np.float32)
    X[:, 2] = np.round(X[:, 2])              # ties
    y = (X[:, 0] > 0).astype(np.float32)
    stats = sc.compute_statistics(X, y, device="cpu")
    errs = chip_smoke.checker_oracle(X, y, stats, "cpu")
    assert errs["ranks_exact"]
    bad = dict(stats, variance=stats["variance"] * (1 + 1e-3))
    with pytest.raises(AssertionError, match="variance_rel"):
        chip_smoke.checker_oracle(X, y, bad, "cpu")
    bad = dict(stats, spearman=stats["spearman"] + 1e-3)
    with pytest.raises(AssertionError, match="spearman_abs"):
        chip_smoke.checker_oracle(X, y, bad, "cpu")


def test_kernels_line_adds_the_workflow_launches():
    row = {k: 1.5 for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                            "max_abs_err", "call_ms", "plain_call_ms",
                            "library_call_ms", "span_ms",
                            "library_device_ms")}
    row["bound_by"] = "bytes"
    rows = [dict(row, form="identity", shape=[1], dtype="f"),
            dict(row, form="prefix", shape=[2], act="a", dtype="f")]
    hrows = [dict(row, dtype="f", **{k: 1 for k in "GndSmB"})]
    rrows = [dict(row, layout="one card", shape="gbt_level",
                  ndev=chip_smoke.DP_RANKS, dims=[1])]
    line = chip_smoke.kernels_line(
        rows, {"kernel_launches": 7}, 0.5, hrows,
        {"histogram_launches": 418}, 3, rrows, {"ring_launches": 24},
        {"histogram_launches": 543, "fused_launches": 11})
    hist = line["kernels"][1]
    assert hist["launches"] == 418 + 543
    assert hist["training_launches"] == 418
    assert hist["workflow_launches"] == 543
    assert line["kernels"][0]["launches"] == 7
    assert line["kernels"][0]["workflow_launches"] == 11
    ctr = {"launches": {"fused_linear_scores": 0, "tree_histogram": 0,
                        "ring_allreduce": 0}}
    line = chip_smoke.kernels_line(
        rows, {"kernel_launches": 7}, 0.5, hrows,
        {"histogram_launches": 418}, 3, rrows, {"ring_launches": 24},
        {"histogram_launches": 543, "fused_launches": 11}, ctr)
    assert [k["ctr_launches"] for k in line["kernels"]] == [0, 0, 0]
    assert line["kernels"][1]["launches"] == 418 + 543


@pytest.fixture(scope="module")
def ctr_run():
    """The ctr phase on the CPU at small sizes (2^13 buckets, two 16k-row
    stream chunks, a 6,000-row default-grid sweep, 3,000 front-door
    records): every gate of the phase, here CPU against CPU where the
    card is compared with the CPU."""
    return chip_smoke.ctr_phase(
        0, device="cpu", stream_rows=16384, stream_chunks=2,
        stream_batch=1024, buckets=1 << 13, sweep_rows=6000,
        sweep_chunk=2500, cpu_rows=3000, front_rows=3000, front_chunk=1000,
        requests=12)


def test_ctr_phase_runs_on_the_cpu(ctr_run):
    st, sw, fd, sv = (ctr_run[k] for k in ("stream", "sweep", "front_door",
                                           "serve"))
    assert st["streamed_equals_device_fed"] and st["rows"] == 2 * 16384
    assert st["holdout_auroc"] > chip_smoke.CTR_MIN_AUROC
    for fam, errs in ctr_run["oracle"].items():
        assert max(errs.values()) <= chip_smoke.CTR_ORACLE_RTOL, fam
    assert set(ctr_run["oracle"]) == {"adagrad", "ftrl", "fm"}
    assert sw["bitwise_repeat"] and sw["grid"] == 11
    assert set(sw["family_wall_s"]) == {"adagrad", "ftrl", "fm"}
    assert ctr_run["card_vs_cpu"]["max_loss_gap"] == 0.0  # CPU vs CPU
    assert fd["loaded_scores_bitwise"] and fd["stream_bitwise"]
    assert fd["local_bitwise"]
    assert fd["loco_max_abs_err"] <= chip_smoke.CTR_LOCO_ATOL
    assert list(fd["field_contributions"]) == chip_smoke.CTR_CAT_NAMES
    assert sv["planes"] == ["classic"] and sv["fused_launches"] == 0
    assert sv["max_abs_err"] <= chip_smoke.CTR_SERVE_ATOL
    assert ctr_run["launches"] == {"fused_linear_scores": 0,
                                   "tree_histogram": 0, "ring_allreduce": 0}


def test_ctr_lines_take_every_number_from_the_run(ctr_run):
    import json

    def numbers(v):
        if isinstance(v, dict):
            return [x for u in v.values() for x in numbers(u)]
        if isinstance(v, (list, tuple)):
            return [x for u in v for x in numbers(u)]
        return [v] if isinstance(v, float) else []

    seen = set(numbers(ctr_run))
    lines = chip_smoke.ctr_lines(ctr_run)
    assert len(lines) == 17
    for line in lines:
        body = line.split(": ", 2)[2]
        value = json.loads(body.rsplit(" ", 1)[0] if body.endswith(
            ("s", "ms", "rows/s")) and not body.endswith("}") else body)
        for x in numbers(value):
            assert x in seen, line


@pytest.mark.parametrize("family", ["adagrad", "ftrl", "fm"])
def test_ctr_oracle_flags_a_wrong_update(family):
    """The numpy oracle separates a right step from a planted fault: the
    port's three minibatches at the oracle's hypers pass, the same
    steps at lr (alpha) x 1.01 fail its limit."""
    import numpy as np
    from transmogrifai_tpu_torch.models import sparse as S
    B, steps, batch = 1 << 13, 3, 512
    c = chip_smoke.ctr_chunk(3, steps * batch, B)
    w = np.ones(steps * batch, np.float32)
    emb = (0.01 * np.random.default_rng(1).normal(size=(B, 8))).astype(
        np.float32)
    want = chip_smoke.ctr_np_oracle(family, c["idx"], c["num"], c["y"], B,
                                    steps, batch, emb)
    l2 = chip_smoke.CTR_ORACLE_L2

    def port(scale):
        if family == "ftrl":
            st = S.init_sparse_ftrl(B, chip_smoke.CTR_D, "cpu")
            S.ftrl_epoch(st, c["idx"], c["num"], c["y"], w, 0.1 * scale,
                         1.0, 1e-3, l2, batch)
            return S.ftrl_weights(st, 0.1 * scale, 1.0, 1e-3, l2)
        init = (S.init_sparse_fm(B, chip_smoke.CTR_D, 8, emb=emb,
                                 device="cpu") if family == "fm"
                else S.init_sparse_lr(B, chip_smoke.CTR_D, "cpu"))
        epoch = S.fm_epoch if family == "fm" else S.sparse_lr_epoch
        return epoch(init, S._zero_like_acc(init), c["idx"], c["num"],
                     c["y"], w, 0.05 * scale, l2, batch)[0]

    def err(got):
        return max(float(np.abs(got[k].numpy() - want[k]).max())
                   / float(np.abs(want[k]).max()) for k in ("table",
                                                             "dense"))
    assert err(port(1.0)) <= chip_smoke.CTR_ORACLE_RTOL
    assert err(port(1.01)) > chip_smoke.CTR_ORACLE_RTOL
