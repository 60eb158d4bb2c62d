"""chip_smoke.py's training phase on the CPU: the binary selector over
its default candidate list (the four tree families and LinearSVC,
LogisticRegression, NaiveBayes) at default grids and registered caps,
on 3,000 of its HIGGS-shaped rows. Holds the script's own checks
(winner against the linear yardstick, the scored column, the
exact-mode decision tree bitwise and GBT per grid point, here CPU
against CPU) and the launch count it derives from the code, which the
CPU path does not move. And the GBT check against planted histogram
faults (gbt_parity_probe.py's arms), CPU against CPU: each must part
the trees at a split that is no near tie, and the same analysis on a
decision tree. Then the linear phase (the
oracle, card-vs-CPU here CPU against CPU, the invariance) and the
multiclass and regression default lists at small sizes.
"""
import json

import numpy as np
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
    return X, y, chip_smoke.tree_side("GBTClassifier", X, y, "cpu",
                                      {"TM_KERNEL_EXACT": "1"})


@pytest.mark.parametrize("arm", ["bf16", "drop_row"])
def test_gbt_check_flags_a_planted_histogram_fault(gbt_reference, arm):
    X, y, ref = gbt_reference
    knobs, fault = gbt_parity_probe.ARMS[arm]
    out = chip_smoke.tree_compare(
        "GBTClassifier",
        chip_smoke.tree_side("GBTClassifier", X, y, "cpu", knobs, fault),
        ref, X)
    assert out["gain_gap_max"] > chip_smoke.GBT_GAP_RTOL
    first = [d for d in out["divergence"] if d]
    assert first and all(d["hist_rel_diff"] > chip_smoke.GBT_HIST_RTOL
                         for d in first)


def test_tree_check_flags_a_planted_decision_tree_fault(gbt_reference):
    """The near-tie analysis on a single tree of two classes (stats
    g_1, g_2, h_1, h_2, w): a planted histogram fault parts the trees at
    a split that is no near tie."""
    X, y, _ = gbt_reference
    fam, knobs = "DecisionTreeClassifier", {"TM_KERNEL_EXACT": "1"}
    ref = chip_smoke.tree_side(fam, X, y, "cpu", knobs)
    same = chip_smoke.tree_compare(
        fam, chip_smoke.tree_side(fam, X, y, "cpu", knobs), ref, X)
    assert same["divergence"] == [None] * len(ref["grid"])
    out = chip_smoke.tree_compare(fam, chip_smoke.tree_side(
        fam, X, y, "cpu", knobs, gbt_parity_probe.drop_last_row), ref, X)
    assert out["gain_gap_max"] > chip_smoke.GBT_GAP_RTOL


def test_hist_hook_records_each_levels_shape():
    X, y = chip_smoke.training_data(0, 500)
    shapes = []
    with chip_smoke.hist_hook(shapes=shapes):
        chip_smoke.tree_cv("DecisionTreeClassifier", X, y, "cpu", {})
    fam = TM.MODEL_FAMILIES["DecisionTreeClassifier"]
    levels = fam.levels_per_fit()            # the folded grid, the refit
    assert [s[4] for s in shapes] == [1 << i for i in range(levels)] * 2
    assert [s[0] for s in shapes] == [3 * 2] * levels + [1] * levels
    assert {s[2] for s in shapes} == {X.shape[1]}
    assert {(s[3], s[5]) for s in shapes} == {(5, fam.n_bins)}
    assert chip_smoke.path_hist_check([], "none", 0) is None


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
    for key, form in (("table_form", "table"), ("generic_form", "generic")):
        f = wf[key]
        assert f["form"] == form and f["failed"] == 0
        assert f["fused_fallbacks"] == 0 and f["fused_batches"] > 0
        assert sum(f["matched"].values()) == f["requests"]
        assert f["matched"]["fused"] > 0
        assert f["max_abs_err"] <= chip_smoke.SERVE_ATOL
    # Titanic's boundary: 4 numeric columns, the label, pivots 5/4/22/5
    assert wf["table_form"]["boundary_slots"] == 41
    assert wf["fused_launches"] == 0


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
    ("GBTClassifier", "GBTClassifier metrics recomputed on the card")])
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
    forms = {f"{f}_form": {"kernel": dict(row, shape=[3], act="a",
                                          dtype="f"),
                           "kernel_launches": n, "fused_slices": n}
             for f, n in (("table", 5), ("generic", 6))}
    line = chip_smoke.kernels_line(
        rows, {"kernel_launches": 7}, 0.5, hrows,
        {"histogram_launches": 418}, 3, rrows, {"ring_launches": 24},
        dict(forms, histogram_launches=543, fused_launches=11 + 5 + 6))
    fused = line["kernels"][0]
    assert fused["workflow_launches"] == 22
    assert (fused["table_form"]["launches"],
            fused["generic_form"]["fused_slices"]) == (5, 6)
    assert fused["table_form"]["bound_by"] == "bytes"


def test_form_lines_take_every_number_from_the_run():
    """Each form's line carries its kernel row and both passes' numbers,
    every one from the run's result."""
    import re
    wf, seen = {}, set()
    for j, (key, form) in enumerate((("table_form", "table"),
                                     ("generic_form", "generic"))):
        vals = iter(100.0 * j + k + 0.25 for k in range(20))

        def pass_():
            return {k: next(vals) for k in ("device_ops_per_pass",
                                            "device_us_per_pass",
                                            "host_us_per_pass")}
        wf[key] = {"form": form, "pass_models": 4, "pass_rows": 60,
                   "kernel_launches": 9, "fused_slices": 9,
                   "fused_pass": pass_(), "classic_pass": pass_(),
                   "kernel": {"shape": [64, 41, 24, 4, 1], "dtype": "bf16",
                              "ms": next(vals), "plain_ms": next(vals),
                              "bound_ms": next(vals), "bound_by": "bytes",
                              "max_abs_err": next(vals)}}
        seen |= {v for d in (wf[key]["fused_pass"], wf[key]["classic_pass"],
                             wf[key]["kernel"]) for v in d.values()
                 if isinstance(v, float)}
    lines = chip_smoke.form_lines(wf)
    assert len(lines) == 2
    for line in lines:
        found = [float(x) for x in re.findall(r"\d+\.\d+", line)]
        assert len(found) == 10 and set(found) <= seen, line


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


# -- features: every feature type through transmogrify ----------------------

FEATURE_CANDIDATES = [["LogisticRegression", {"regParam": [0.1]}],
                      ["DecisionTreeClassifier", None]]


@pytest.fixture(scope="module")
def features_run():
    """The features phase on the CPU at small sizes (the CRM workflow at
    300 rows, the every-type one at 600, the card-vs-CPU gate at 300,
    OpLDA on 500 documents), the two default lists replaced by LR and DT
    for time: every gate of the phase, CPU against CPU where the card is
    compared with the CPU."""
    return chip_smoke.features_phase(
        0, device="cpu", crm_rows=300, every_rows=600, parity_rows=300,
        lda_docs=500, candidates=FEATURE_CANDIDATES)


def test_features_phase_runs_on_the_cpu(features_run):
    crm, ev, pa = (features_run[k] for k in ("crm", "every_type", "parity"))
    assert crm["predictors"] == 56 and crm["rows_cut_from"] == \
        chip_smoke.FEAT_CRM_ROWS
    for name in ("automl", "default_list"):
        r = crm[name]
        assert r["loaded_scores_bitwise"] and r["local_rows"] == 300
        assert r["local_max_abs_err"] <= chip_smoke.FEAT_LOCAL_ATOL
        assert r["histogram_launches"] == r["expected_launches"] == 0
        assert r["device_busy_share"] is None        # the profiler: CUDA
    assert crm["default_list"]["raw_filter_excluded"] == []
    assert ev["holdout_auroc"] >= chip_smoke.FEAT_MIN_AUROC
    assert ev["sensitive"][0]["actionTaken"] == "removed"
    assert ev["lda_vocab"] == chip_smoke.LDA_K * 30
    assert pa["lam_max_abs_gap"] == 0.0                  # CPU vs CPU
    assert set(pa["cv_gap"].values()) == {0.0}
    assert pa["matrix_max_abs_gap"] == 0.0
    assert sorted(pa["trees_on_card_matrix"]) == ["DecisionTreeClassifier",
                                                  "GBTClassifier"]
    for t in pa["trees_on_card_matrix"].values():
        assert t["metric_max_diff"] == 0.0 and not any(t["divergence"])
    assert features_run["hist_checks"] == []     # the kernel: CUDA only
    la = features_run["lda"]
    assert la["shape"] == [500, chip_smoke.LDA_VOCAB, chip_smoke.LDA_K]
    assert la["bound_ms"] > 0 and "device_ms" not in la
    assert features_run["house"]["seller_slots"] == 0
    assert features_run["house"]["median_rel_dollar_error"] < \
        chip_smoke.HOUSE_MAX_REL_ERR
    assert features_run["artifact"]["max_rel_err"] <= \
        chip_smoke.ARTIFACT_RTOL
    assert features_run["launches"] == {"fused_linear_scores": 0,
                                        "ring_allreduce": 0,
                                        "tree_histogram": 0}


def test_features_lines_take_every_number_from_the_run(features_run):
    import copy
    run = copy.deepcopy(features_run)
    run["crm"]["automl"]["train_wall_s"] = 12345.5
    run["every_type"]["kept_slots"] = 4321
    run["lda"]["device_ms"] = 777.25
    run["parity"]["lam_max_abs_gap"] = 0.0625
    lines = chip_smoke.features_lines(run)
    assert all(line.startswith("phase features: ") for line in lines)
    text = "\n".join(lines)
    for value in ("12345.5", "4321", "777.25", "0.0625",
                  f"cut from {chip_smoke.FEAT_CRM_ROWS}"):
        assert value in text
    assert "crm default_list histogram launches: 0" in text
    assert "GBTClassifier on the card's matrix, card vs CPU" in text
    row = {k: 7 for k in ("G", "n", "d", "S", "m", "B", "levels",
                          "distinct_shapes")}
    run["hist_checks"] = [dict(row, shape="every_type", dtype="bfloat16",
                               max_abs_err=0.03125)]
    text = "\n".join(chip_smoke.features_lines(run))
    assert "every_type train's largest level" in text and "0.03125" in text


def test_lda_bound_reads_the_count_matrix_once_an_e_step_iteration():
    byts, flops = chip_smoke.lda_cost(100_000, 256, 8)
    assert byts == 30 * (20 + 1) * 100_000 * 256 * 4
    assert flops == (30 * 20 + 30) * 4 * 100_000 * 8 * 256
    assert byts / chip_smoke.HBM_BYTES_PER_S > \
        flops / chip_smoke.F32_FLOPS_PER_S


def test_parity_gate_flags_a_planted_lambda_fault():
    with pytest.raises(AssertionError, match="lambda card vs CPU"):
        chip_smoke.parity_part(0, "cpu", 200,
                               check=lambda lam: lam * (1 + 1e-3))


def test_kernels_line_adds_the_features_launches():
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
    fe = {"histogram_launches": 668,
          "launches": {"fused_linear_scores": 0, "ring_allreduce": 0,
                       "tree_histogram": 668}}
    line = chip_smoke.kernels_line(
        rows, {"kernel_launches": 7}, 0.5, hrows,
        {"histogram_launches": 418}, 3, rrows, {"ring_launches": 24},
        {"histogram_launches": 543, "fused_launches": 11}, None, fe)
    assert line["kernels"][1]["launches"] == 418 + 543 + 668
    assert line["kernels"][1]["max_abs_err"] == 1.5
    fe["hist_checks"] = [{"max_abs_err": 2.5}]
    assert chip_smoke.kernels_line(
        rows, {"kernel_launches": 7}, 0.5, hrows,
        {"histogram_launches": 418}, 3, rrows, {"ring_launches": 24},
        None, None, fe)["kernels"][1]["max_abs_err"] == 2.5
    assert [k["features_launches"] for k in line["kernels"]] == [0, 668, 0]
    assert line["kernels"][0]["launches"] == 7


# -- fleet: the serving tier ---------------------------------------------------

#: the fleet phase at its CPU size: two replicas (one cannot fail over),
#: two socket workers, about a second of traffic each
FLEET_SMALL = dict(replicas=2, rps=60.0, steady_s=0.6, failover_s=0.6,
                   window_s=0.3, v2_requests=16, workers=2,
                   xhost_rps=60.0, xhost_s=1.0, wf_rows=600,
                   cli_requests=8)


@pytest.fixture(scope="module")
def fleet_run():
    """The fleet phase on the CPU at FLEET_SMALL: every gate of the
    phase (the kernel counts, CUDA only, must stay 0)."""
    return chip_smoke.fleet_phase(0, device="cpu", **FLEET_SMALL)


def test_fleet_phase_runs_on_the_cpu(fleet_run):
    ip, so, cli, co = (fleet_run[k] for k in ("inproc", "socket", "cli",
                                              "continuum"))
    for part in (ip, so):
        assert part["lost_requests"] == part["client_errors"] == 0
        assert part["replica_crashes"] == part["replica_restarts"] == 1
        assert part["max_abs_err_vs_numpy"] <= chip_smoke.SERVE_ATOL
        assert part["max_abs_err_vs_alone"] <= chip_smoke.FLEET_REF_ATOL
    assert ip["replicas"] == 2 and so["workers"] == 2
    assert ip["rollout"]["rolled_back"] is False
    assert ip["v2_default_requests"] > 0
    assert ip["kernel_launches"] == 0 and ip["fused_slices"] > 0
    assert ip["device_busy_share"] is None          # the profiler: CUDA
    assert sum(ip["matched"].values()) == ip["requests"] + ip["v2_requests"]
    assert so["restarted_served"] > 0 and so["worker_launches"] == 0
    assert {w["device"] for w in so["per_worker"].values()} == {"cpu"}
    assert all(w["wire_p50_us"] is not None
               for w in so["per_worker"].values())
    assert cli["ok"] == cli["requests"] == 8
    assert cli["max_abs_err"] <= chip_smoke.CLI_ATOL
    assert cli["stream_max_abs_err"] <= chip_smoke.CLI_ATOL
    assert cli["spans_written"] > 0
    assert co["promotions"] == 1 and co["client_errors"] == 0
    assert set(so["metricsz_families"]) | set(co["metricsz_families"]) == \
        set(chip_smoke.FLEET_METRIC_FAMILIES)
    assert fleet_run["kernel_launches"] == 0


def test_fleet_lines_take_every_number_from_the_run(fleet_run):
    import copy
    run = copy.deepcopy(fleet_run)
    run["inproc"]["steady_p99_ms"] = 12345.5
    run["inproc"]["failovers"] = 4321
    run["socket"]["recovered_p50_ms"] = 777.25
    name = sorted(run["socket"]["per_worker"])[0]
    run["socket"]["per_worker"][name]["wire_p99_us"] = 0.0625
    run["cli"]["engine_wall_s"] = 98.5
    run["continuum"]["wall_s"] = 3.125
    run["phase_wall_s"] = 61.75
    run["inproc"]["device_busy_share"] = 0.015625
    lines = chip_smoke.fleet_lines(run)
    assert all(line.startswith("phase fleet: ") for line in lines)
    text = "\n".join(lines)
    for value in ("12345.5", "4321", "777.25", "0.0625", "98.5", "3.125",
                  "61.75", "0.015625"):
        assert value in text


@pytest.mark.parametrize("fault,match", [
    ("v1_after_rollout", "numpy score|lacks"),
    ("lost", "lost|client errors"),
], ids=["v1_weights_after_rollout", "lost_request"])
def test_fleet_gates_flag_a_planted_fault(tmp_path, fault, match):
    import torch as _torch
    root = str(tmp_path / "catalog")
    catalog = chip_smoke.write_catalog(root, 0)
    v2_path = str(tmp_path / "v2")
    v2 = (v2_path, chip_smoke.write_v2(v2_path, 0))
    with pytest.raises(AssertionError, match=match):
        chip_smoke.inproc_fleet_part(
            0, _torch.device("cpu"), root, catalog, v2, replicas=2,
            rps=60.0, steady_s=0.4, failover_s=0.4, window_s=0.2,
            v2_requests=32, fault=fault)


def test_worker_gate_flags_a_worker_on_the_cpu(fleet_run):
    """A worker whose status reports the CPU fails the card's gate, as
    does one that launched no kernel or fell back."""
    import copy
    import torch as _torch
    snap = {"device": {"device": "cuda:0",
                       "kernels": {"fused_linear_scores": 5}},
            "engine": {"fused_batches": 5, "fused_fallbacks": 0},
            "transport": {"pid": 1, "generation": 1}}
    cuda = _torch.device("cuda")
    assert chip_smoke.check_workers({"r0": snap}, cuda)["r0"]["launches"] == 5
    on_cpu = copy.deepcopy(snap)
    on_cpu["device"]["device"] = "cpu"
    with pytest.raises(AssertionError, match="reports device cpu"):
        chip_smoke.check_workers({"r0": snap, "r1": on_cpu}, cuda)
    idle = copy.deepcopy(snap)
    idle["device"]["kernels"]["fused_linear_scores"] = 0
    with pytest.raises(AssertionError, match="launched no fused kernel"):
        chip_smoke.check_workers({"r0": idle}, cuda)
    fell = copy.deepcopy(snap)
    fell["engine"]["fused_fallbacks"] = 2
    with pytest.raises(AssertionError, match="fallbacks"):
        chip_smoke.check_workers({"r0": fell}, cuda)


def test_kernels_line_adds_the_fleet_launches():
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
    fl = {"inproc": {"kernel_launches": 31, "profiler_kernel_launches": 31},
          "socket": {"worker_launches": 17}}
    line = chip_smoke.kernels_line(
        rows, {"kernel_launches": 7}, 0.5, hrows,
        {"histogram_launches": 418}, 3, rrows, {"ring_launches": 24},
        None, None, None, fl)
    assert line["kernels"][0]["fleet_launches"] == {
        "inproc": 31, "inproc_profiler": 31, "workers": 17}
    assert line["kernels"][0]["launches"] == 7


# -- phase 12: the FT-Transformer ---------------------------------------------

@pytest.fixture(scope="module")
def ft_run():
    """The FT phase on the CPU at a small size (192 rows, 3 AdamW steps,
    the wide point at d_model 32 / d_ff 64): every gate of the phase,
    CPU against CPU where the card is compared with the CPU."""
    from transmogrifai_tpu_torch.models import serving_kernels as sk
    counters = (tk.histogram_grid, tk.ring_allreduce, sk.fused_linear_scores)
    old = [c.launches for c in counters]
    # an earlier phase's counts: the phase reads its own difference and
    # must reset none of them
    for i, c in enumerate(counters):
        c.launches = 100 + i
    try:
        run = chip_smoke.ft_phase(0, device="cpu", rows=192, wide=(32, 64),
                                  n_steps=3)
        run["counters_after"] = [c.launches for c in counters]
    finally:
        for c, v in zip(counters, old):
            c.launches = v
    return run


def test_ft_phase_runs_on_the_cpu(ft_run):
    grids = ft_run["grids"]
    assert [(g["d_model"], g["dtype"]) for g in grids] == [
        (32, "torch.float32")] * 4          # bf16 is CUDA's default only
    for g in grids:
        assert g["fits"] == 18 and g["grid"] == 6 and g["folds"] == 3
        assert g["chunk"] == 1 and g["instances_computed"] == 18
        assert g["adam_steps"] == 3 and g["rows"] == 192
        assert g["bound_ms"] > 0 and g["bound_by"] == "operations"
        assert "step_device_ms" not in g        # the profiler: CUDA
        assert "device_busy_share" not in g
    assert ft_run["bf16_vs_f32_auroc_gap"] == 0.0
    assert ft_run["card_vs_cpu"]["max_abs_gap"] == 0.0    # CPU vs CPU
    f = ft_run["front"]
    assert sorted(f["cv_best_auroc"]) == ["FTTransformerClassifier",
                                          "LogisticRegression"]
    assert f["served_family"] == "FTTransformerClassifier"
    assert f["loaded_scores_bitwise"] and f["local_rows"] == 100
    assert f["local_max_abs_err"] <= chip_smoke.FT_ROW_ATOL
    assert f["serve_max_abs_err"] <= chip_smoke.FT_ROW_ATOL
    assert f["planes"] == ["classic"] and f["fused_fallbacks"] >= 1
    assert ft_run["launches"] == {"fused_linear_scores": 0,
                                  "ring_allreduce": 0, "tree_histogram": 0}
    assert ft_run["counters_after"] == [100, 101, 102]
    assert TM.MODEL_FAMILIES["FTTransformerClassifier"].n_steps == 200


def test_ft_lines_take_every_number_from_the_run(ft_run):
    import copy
    run = copy.deepcopy(ft_run)
    run["grids"][0]["wall_s"] = 12345.5
    run["grids"][1]["step_device_ms"] = 777.25
    run["grids"][2]["device_busy_share"] = 0.0625
    run["card_vs_cpu"]["max_abs_gap"] = 0.03125
    run["front"]["p99_ms"] = 98.5
    run["wall_s"] = 61.75
    lines = chip_smoke.ft_lines(run)
    assert all(line.startswith("phase ft: ") for line in lines)
    text = "\n".join(lines)
    for value in ("12345.5", "777.25", "0.0625", "0.03125", "98.5",
                  "61.75", "not measured"):
        assert value in text


def test_ft_bound_uses_the_bench_formulas():
    import bench
    args = (896, 16, 18, 32, 2, 64, 200)
    assert chip_smoke.ft_flops(*args) == bench._ft_flops(*args)
    assert chip_smoke.ft_bytes(*args) == bench._ft_bytes(*args)
    wide = (896, 16, 18, 128, 2, 256, 200)
    assert chip_smoke.ft_flops(*wide) == bench._ft_flops(*wide)
    assert chip_smoke.ft_bytes(*wide) == bench._ft_bytes(*wide)


def test_ft_card_vs_cpu_gate_flags_a_planted_fault():
    X, y = chip_smoke.ft_data(0, rows=64)
    with chip_smoke.ft_sizes(16, 32, 5):
        chip_smoke.ft_cpu_part(X, y, "cpu")
        with pytest.raises(AssertionError, match="FT card vs CPU"):
            chip_smoke.ft_cpu_part(X, y, "cpu",
                                   fits_check=lambda p: p + 0.01)


def test_ft_served_gate_flags_a_row_mix_up(monkeypatch, tmp_path):
    """A served answer that carries another row's score of its request
    (each answer's rows rolled by one) fails the FT_ROW_ATOL gate."""
    real = chip_smoke._storm

    def mixed(*args, **kwargs):
        results, lat, wall = real(*args, **kwargs)
        return ([{c: np.roll(np.asarray(v), 1, axis=0) for c, v in r.items()}
                 for r in results], lat, wall)

    monkeypatch.setattr(chip_smoke, "_storm", mixed)
    with chip_smoke.ft_sizes(16, 32, 3):
        with pytest.raises(AssertionError, match="FT served rows differ"):
            chip_smoke.ft_front_part("cpu", str(tmp_path), requests=16,
                                     local_rows=10)


# -- phase 7b: multi-device on ranks that share one card ----------------------

MESH_CANDIDATES = [["LogisticRegression", {"regParam": [0.01, 0.1]}],
                   ["DecisionTreeClassifier", None], ["NaiveBayes", None]]
MESH_SMALL = dict(ctr_rows=5000, ctr_batch=1024, buckets=1 << 13)


@pytest.fixture()
def one_thread():
    """One torch thread: the CPU's index_put_ accumulation over several
    threads adds in an order that varies from run to run, which the
    phase's ring-against-plain check would see."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mesh_phase_runs_on_the_cpu(one_thread):
    """The mesh phase on 4 CPU ranks at small sizes (3,001 rows of
    statistics, a 5,000-row CTR chunk at 2^13 buckets and batch 1,024, a
    3-candidate list with a tree at 2,000 rows): every gate, the CPU
    path launching no kernel."""
    out = chip_smoke.mesh_phase(0, device="cpu", rows=3001,
                                list_rows=2000,
                                candidates=MESH_CANDIDATES, **MESH_SMALL)
    st = out["stats"]
    assert st["ring_equals_plain"] and st["oracle"]["ranks_exact"]
    assert st["ring_allreduce_launches"] == st["expected_launches_each"] == 0
    ck = out["checker"]
    assert ck["drops_equal"] and set(ck["dropped"]) == {"x_col_28",
                                                         "x_col_29"}
    fams = out["sparse"]["families"]
    assert set(fams) == {"lr", "fm", "softmax"}
    for f in fams.values():
        assert f["ring_equals_plain"]
        assert f["max_abs_err"] <= 1e-4
        assert f["ring_launches"] == f["expected_ring_launches"] == 0
        assert f["ring_bound_by"] == "bytes" and "step_ms" not in f
    grid = out["grid"]
    assert grid["grid_bitwise"] and grid["sizes"] == [1, 2, 4]
    items = [sum(r["items"].values()) for r in grid["runs"].values()]
    # 3 folds x (LR's 2 x 2 elastic-net grid + DT's 2 + NB's 1)
    assert len(set(items)) == 1 and items[0] == 3 * (4 + 2 + 1)
    assert len(grid["runs"]["4"]["items"]) == 4
    assert out["histogram_launches"] == 0


def test_mesh_phase_flags_a_local_sum_of_weights(monkeypatch, one_thread):
    """A planted fault: each rank's sparse step normalised by its own Σw
    (the reduced Σw a share of one). The phase must fail its one-device
    comparison."""
    from transmogrifai_tpu_torch.models import sparse as TS
    real = TS._rank_parts

    def local_mean(grad_fn, *a, **k):
        buf = real(lambda *ga, mean=False: grad_fn(*ga, mean=True), *a,
                   **k)
        buf[0] = 1.0 / chip_smoke.MESH_RANKS
        return buf

    monkeypatch.setattr(TS, "_rank_parts", local_mean)
    with pytest.raises(AssertionError, match="one-device fit"):
        chip_smoke.mesh_sparse_part(0, "cpu", rows=5000, batch=1024,
                                    buckets=1 << 13)


def test_mesh_phase_flags_shards_put_back_out_of_order(monkeypatch,
                                                       one_thread):
    """A planted fault: a grid shard's items put back in the wrong order
    (the ranks' results concatenated last rank first). The grid metrics
    then differ across mesh sizes and the phase must fail."""
    from transmogrifai_tpu_torch.parallel import mesh as tmesh
    real = tmesh._concat
    monkeypatch.setattr(tmesh, "_concat", lambda *parts: real(*parts[::-1]))
    with pytest.raises(AssertionError, match="differ from 1 rank"):
        chip_smoke.mesh_grid_part(0, "cpu", rows=2000,
                                  candidates=MESH_CANDIDATES)


def test_kernels_line_adds_the_mesh_launches():
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
    mesh = {"ring_allreduce_launches": 200, "ring_allgather_launches": 8,
            "histogram_launches": 1000}
    line = chip_smoke.kernels_line(
        rows, {"kernel_launches": 7}, 0.5, hrows,
        {"histogram_launches": 418}, 3, rrows, {"ring_launches": 24},
        mesh=mesh)
    hist, ring = line["kernels"][1], line["kernels"][2]
    assert hist["launches"] == 1418 and hist["mesh_launches"] == 1000
    assert ring["launches"] == 232 and ring["data_parallel_launches"] == 24
    assert ring["mesh_launches"] == {"allreduce": 200, "allgather": 8}


# -- the 2-D grid x data mesh, the multi-process launch, the services ------

MESH2D_CANDIDATES = [["LogisticRegression", {"regParam": [0.01, 0.1]}],
                     ["DecisionTreeClassifier", None],
                     ["RandomForestClassifier", None], ["NaiveBayes", None]]


@pytest.fixture()
def cpu_pool(monkeypatch, one_thread):
    """The default meshes draw from the CPU (the phases make their own
    pools of ranks on it)."""
    from transmogrifai_tpu_torch.parallel import mesh as tmesh
    monkeypatch.setattr(tmesh, "visible_devices",
                        lambda: [torch.device("cpu")])
    return monkeypatch


def test_mesh2d_phase_runs_on_the_cpu(cpu_pool):
    """The mesh2d phase on 2 x 2 CPU ranks at small sizes (2,000 rows, a
    4-candidate list with DT and RF): the sketch bitwise, the two grid
    rows' sums bitwise plain, the list within the tolerances of the
    one-rank fit (DT and RF bitwise) with the same winner, every rank
    attributed through the 2-D runners, the CPU launching no kernel."""
    out = chip_smoke.mesh2d_phase(0, device="cpu", rows=2000,
                                  candidates=MESH2D_CANDIDATES)
    assert out["sketch"]["bitwise"] and out["ring"]["ring_equals_plain"]
    lst = out["list"]
    assert lst["labels"] == ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]
    assert lst["max_gap"]["DecisionTreeClassifier"] == 0.0
    assert lst["max_gap"]["RandomForestClassifier"] == 0.0
    # 3 folds x (LR 2 x 2 + DT 2 + RF 2 + NB 1), on both ranks of a row
    assert sum(lst["items"].values()) == 2 * 3 * (4 + 2 + 2 + 1)
    assert any(p.startswith("folded2d/") for p in lst["programs"])
    assert out["histogram_launches"] == 0
    assert out["ring_allreduce_launches"] == 0


def test_mesh2d_phase_flags_a_per_shard_sketch(cpu_pool, monkeypatch):
    """A planted fault: each rank's quantile sketch from its own rows (no
    gather). The sketch's edges then differ from the unsharded ones and
    the phase must fail."""
    from transmogrifai_tpu_torch.parallel import spmd
    monkeypatch.setattr(spmd, "gather_rows",
                        lambda *parts: tuple(t for t, _ in parts))
    X, _ = chip_smoke.training_data(0, 2000)
    with pytest.raises(AssertionError, match="differ from the unsharded"):
        chip_smoke.mesh2d_sketch_part(X, "cpu")


def test_mesh2d_phase_counts_only_the_selector_fit(monkeypatch):
    """The phase's launch counts (those the kernels line reports) are
    the selector fit's alone: the sketch's and the ring's own checks
    launch the ring too, and keep their counts in their parts."""
    monkeypatch.setattr(chip_smoke, "training_data",
                        lambda seed, rows: (np.zeros((4, 2)), None))
    monkeypatch.setattr(chip_smoke, "mesh2d_sketch_part",
                        lambda *a: {"ring_allgather_launches": 2})
    monkeypatch.setattr(chip_smoke, "mesh2d_ring_part",
                        lambda *a: {"launches": 4})
    monkeypatch.setattr(chip_smoke, "mesh2d_list_part", lambda *a: {
        "histogram_launches": 1240, "ring_allreduce_launches": 3084,
        "ring_allgather_launches": 44})
    out = chip_smoke.mesh2d_phase(0, device="cpu")
    assert (out["histogram_launches"], out["ring_allreduce_launches"],
            out["ring_allgather_launches"]) == (1240, 3084, 44)
    assert out["sketch"]["ring_allgather_launches"] == 2
    assert out["ring"]["launches"] == 4


def test_multihost_phase_runs_on_the_cpu(cpu_pool):
    """Two worker processes on CPU ranks (2 each) joined by a localhost
    gloo group, the LR + GBT list at 1,500 rows through WorkflowRunner
    with OpParams.distributed: both exit 0 with the same metrics and
    winner, within the tolerances of one process; every rank of both
    processes on the hybrid mesh."""
    out = chip_smoke.multihost_phase(0, device="cpu", rows=1500,
                                     timeout_s=240,
                                     worker_env={"OMP_NUM_THREADS": "1"})
    assert [w["mesh"]["local_rows"] for w in out["workers"]] == [[0], [1]]
    for w in out["workers"]:
        assert w["mesh"]["labels"] == ["p0/cpu:0", "p0/cpu:1", "p1/cpu:0",
                                       "p1/cpu:1"]
        assert w["info"]["device_count"] == 4
    assert out["max_gap"]["LogisticRegression"] <= 1e-4
    assert out["histogram_launches"] == 0


def test_multihost_phase_fails_with_a_failed_worker(cpu_pool):
    """A planted fault: the workers cannot build their mesh (an unknown
    mesh axis). Their failure fails the phase; nothing is caught."""
    with pytest.raises(AssertionError, match="multihost worker 0 exited"):
        chip_smoke.multihost_phase(0, device="cpu", rows=600, timeout_s=120,
                                   worker_env={"TM_MESH_AXIS": "bogus"})


def test_services_phase_runs_on_the_cpu(tmp_path):
    """debugNans on the CPU (the checker's raise at full_like, the train
    without it completing, a planted 0/0 naming div) and the build cache
    (a fresh process's run: nothing built on the CPU, the default
    directory in effect again afterwards)."""
    out = chip_smoke.services_phase("cpu", str(tmp_path))
    dn = out["debug_nans"]
    assert "full_like" in dn["titanic_with_checker"]
    assert "div" in dn["planted"]
    bc = out["build_cache"]
    assert bc["built"] == [] and bc["histogram_launches"] == 0


def test_kernels_line_adds_the_mesh2d_and_multihost_launches():
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
    mesh = {"ring_allreduce_launches": 200, "ring_allgather_launches": 8,
            "histogram_launches": 1000}
    m2 = {"ring_allreduce_launches": 3084, "ring_allgather_launches": 44,
          "histogram_launches": 1240}
    mh = {"ring_allreduce_launches": 900, "ring_allgather_launches": 12,
          "histogram_launches": 720}
    line = chip_smoke.kernels_line(
        rows, {"kernel_launches": 7}, 0.5, hrows,
        {"histogram_launches": 418}, 3, rrows, {"ring_launches": 24},
        mesh=mesh, mesh2d=m2, multihost=mh)
    hist, ring = line["kernels"][1], line["kernels"][2]
    assert hist["launches"] == 418 + 1000 + 1240 + 720
    assert hist["mesh2d_launches"] == 1240
    assert hist["multihost_launches"] == 720
    assert ring["launches"] == 24 + 208 + 3128 + 912
    assert ring["mesh2d_launches"] == {"allreduce": 3084, "allgather": 44}
    assert ring["multihost_launches"] == {"allreduce": 900,
                                          "allgather": 12}


# ---------------------------------------------------------------------------
# the autotune phase, rehearsed on CPU tensors at small sizes
# ---------------------------------------------------------------------------

#: (label, G, n, d, S, m, B, exact) and (label, n, C, p, K, L, form)
TUNE_HIST_SMALL = [("small", 2, 300, 5, 3, 4, 8, False),
                   ("small_exact", 2, 300, 5, 3, 4, 8, True)]
TUNE_SERVE_SMALL = [("prefix", 20, 6, 5, 3, 1, "prefix"),
                    ("identity", 20, 5, 5, 3, 1, "identity")]


@pytest.fixture(scope="module")
def autotune_run():
    return chip_smoke.autotune_phase(
        0, device="cpu", mix={5: 3, 9: 2, 40: 1}, hist=TUNE_HIST_SMALL,
        serve=TUNE_SERVE_SMALL,
        candidates=[["DecisionTreeClassifier", None]])


def test_autotune_phase_runs_on_the_cpu(autotune_run):
    """Every candidate measured and bitwise the static launch (the
    plain version on the CPU), both models fitted and saved, Titanic's
    CV metrics and histograms bitwise with the hooks on, no decision on
    the CPU (the hooks are consulted on CUDA only), the ladder applied
    through the engine swap with the rows rescored bitwise."""
    from transmogrifai_tpu_torch import autotune as at
    out = autotune_run
    assert [r["label"] for r in out["hist"]] == ["small", "small_exact"]
    assert all(r["candidates"] == len(r["measurements"]) > 1
               for r in out["hist"] + out["serve"])
    for r in out["hist"] + out["serve"]:
        assert r["best_ms"] == min(m["ms"] for m in r["measurements"])
        assert r["chosen_ms"] in [m["ms"] for m in r["measurements"]]
        assert r["chosen_is_best"] == (r["chosen_ms"] == r["best_ms"]
                                       and r["chosen"] == r["best"])
    at.KernelCostModel.from_json(out["kernel_model"])
    at.ServingCostModel.from_json(out["serving_model"])
    assert out["titanic_cv_bitwise"] and out["titanic_levels"] > 0
    assert (out["hist_decisions"], out["serve_decisions"]) == (0, 0)
    b = out["buckets"]
    assert b["current"] == list(chip_smoke.BUCKETS)
    assert b["expected_padded_rows_proposed"] < b[
        "expected_padded_rows_current"]
    assert b["rescored_bitwise"] and b["batches"] == 6
    json.dumps(out)


def test_autotune_lines_take_every_number_from_the_run(autotune_run):
    lines = chip_smoke.autotune_lines(autotune_run)
    assert len(lines) == 4 + 1 + 1
    for r in autotune_run["hist"] + autotune_run["serve"]:
        line = next(ln for ln in lines if ln.startswith(
            f"autotune {r['label']}:"))
        for key in ("static_ms", "chosen_ms", "best_ms", "predicted_ms"):
            assert str(r[key]) in line


def test_autotune_phase_flags_a_candidate_that_changes_the_output(
        monkeypatch):
    """A launch config that moved a bit of the histogram fails the
    phase's gate (planted: the wrapper perturbs the output under one
    candidate)."""
    real = tk.histogram_grid

    def planted(bins, stats, pos, m, B, *, config=None):
        out = real(bins, stats, pos, m, B, config=config)
        if config is not None and config.get("sort_chunk_rows") == 256:
            out = out.clone()
            out.view(-1)[0] += 1.0
        return out

    monkeypatch.setattr(tk, "histogram_grid", planted)
    with pytest.raises(AssertionError, match="differs from the static"):
        chip_smoke.tune_hist_part(TUNE_HIST_SMALL[:1], 0, "cpu")


class _FakeTrace:
    """A stand-in for a torch.profiler trace: ``kernels`` device kernels
    named like the scorer's, each 2 us long."""

    def __init__(self, kernels):
        from types import SimpleNamespace
        from torch.autograd import DeviceType
        self._events = [SimpleNamespace(
            device_type=DeviceType.CUDA,
            name="void fused_scores_kernel<8>(...)",
            time_range=SimpleNamespace(start=10.0 * i, end=10.0 * i + 2.0))
            for i in range(kernels)]

    def events(self):
        return self._events


@pytest.mark.parametrize("traced, want", [
    ([4], 0.002),                   # the first trace is whole
    ([3, 4], 0.002),                # a trace that lost a kernel is retaken
    ([3, 2, 1], "[3, 2, 1] device kernels"),    # never whole: raises
    ([5, 4], "[5] device kernels"),  # a kernel too many raises at once
])
def test_kernel_median_ms_takes_only_a_whole_trace(monkeypatch, traced, want):
    sessions = iter(traced)
    calls = []

    def fake_profiled(run, host=True):
        run()
        return _FakeTrace(next(sessions)), None

    monkeypatch.setattr(chip_smoke, "profiled", fake_profiled)

    def fn():
        calls.append(1)

    if isinstance(want, str):
        with pytest.raises(AssertionError, match=want.replace("[", r"\[")
                           .replace("]", r"\]")):
            chip_smoke.kernel_median_ms(fn, "fused_scores_kernel", 4)
    else:
        assert chip_smoke.kernel_median_ms(
            fn, "fused_scores_kernel", 4) == pytest.approx(want)
        assert len(calls) == 1 + 4 * len(traced)
