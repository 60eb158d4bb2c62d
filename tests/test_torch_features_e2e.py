"""The port's feature slice end to end against the JAX package.

* The every-type workflow (``chip_smoke.every_type_data`` /
  ``every_type_workflow``: every type the JAX dispatch knows, the seller
  name column removed as sensitive) trained by both packages on the same
  rows, the port's OpLDA handed the JAX package's initial lambda: the
  same raw columns, the same transmogrified host slots (BITWISE), the
  same kept slots and winner. The LDA topics drift apart in f32 (digamma
  and the products round differently through 30 x 20 E-steps; how far
  depends on the corpus), so the numbers downstream of them are held to
  limits set from readings over seeds 0-5 (the constants below). On the
  JAX package's own checked matrix, the same inputs for both, LR's CV
  metrics agree within 1e-6, DT's CV fits are JAX's tree for tree and
  metric for metric, and GBT's agree with JAX's or part first at a near
  tie (:func:`assert_selector_as_jax`). With ``textarea="smart"`` every
  stage is host code and the checked matrix is bitwise: LR and DT agree
  within 1e-6, GBT is held the same way, RF by its draws to quality.
* A model holding these stages saved by either package loads and scores
  in the other; the checked-in JAX artifact loads and scores in both.
* ``FusedScorer``'s host/device split names the same stages in both.
* A planted fault (a map's key order, one LDA E-step fewer) fails.
* Every module this slice lifted resolves its JAX class keys, as the
  FT-Transformer's (a later slice) now does.
* The Feature DSL verbs build the JAX package's stages.
"""
import importlib
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
import torch_artifact
from torch_mirror import (load_mirror, mirror_cases, port_on_cpu,  # noqa
                          run_mirror_case)
from torch_parity import (assert_same_column, jax_lam0, reset_uids,
                          stage_doc)

J = importlib.import_module("transmogrifai_tpu")
P = importlib.import_module("transmogrifai_tpu_torch")
JW = importlib.import_module("transmogrifai_tpu.workflow")
PW = importlib.import_module("transmogrifai_tpu_torch.workflow")

ROWS = 1000
LR_CV_ATOL = 1e-6
#: readings over seeds 0-5 of the every-type workflow (1,000 rows; with
#: ``textarea="smart"``, 600; ``tests/torch_every_type_probe.py``), each
#: package's workflow on its own matrix: the topics' largest gap 1.2e-7
#: to 1.9e-4 (one LDA E-step fewer: over 100 x TOPIC_ATOL); LR's CV
#: metrics 0 to 1.4e-5 apart; DT's 0.0017 to 0.012, GBT's 0.0039 to
#: 0.015 (a topic a few ulps apart moves a split at a bin edge)
TOPIC_ATOL = 5e-4
LR_WORKFLOW_TOL = 1e-4
TREE_CV_TOL = 0.03
#: GBT's CV fits on one matrix in both packages: the gradients' f32 sums
#: run in another order, so round 0's leaves differ by up to 3.4e-6 of
#: their largest where round 0's splits agree, and every fit parts first
#: where two splits' gains lie within 4.9e-8 of their scale (near ties);
#: the CV metrics then 0.0025 to 0.011 apart (readings over seeds 0-5,
#: both variants)
LEAF_RTOL = 1e-5
GBT_GAP_RTOL = chip_smoke.GBT_GAP_RTOL
GBT_CV_TOL = 0.02
#: RF's draws differ by package: its mean CV metric -0.003 to +0.028
#: apart (the port's higher where widest; seeds 0-5 at 600 rows)
RF_MEAN_TOL = 0.05
SCORE_ATOL = 1e-5
CANDIDATES = [["LogisticRegression", {"regParam": [0.01, 0.1]}],
              ["DecisionTreeClassifier", None], ["GBTClassifier", None]]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_jax_lam0(wf):
    """Hand the JAX package's initial lambda to every OpLDA of ``wf``."""
    todo = list(wf.result_features)
    while todo:
        f = todo.pop()
        if type(f.origin_stage).__name__ == "OpLDA":
            f.origin_stage.lam0 = lambda k, V: jax_lam0(k, V)
        todo += list(f.parents)


def _train(pkg, rows=ROWS, candidates=CANDIDATES, textarea="lda",
           seed=0):
    reset_uids()
    ds, feats = chip_smoke.every_type_data(pkg, rows, seed)
    wf, sel = chip_smoke.every_type_workflow(pkg, feats, candidates,
                                             textarea=textarea)
    if pkg is P:
        _with_jax_lam0(wf)
        return ds, wf.train(ds, device="cpu")
    return ds, wf.train(ds)


def _vector_name(model):
    checker = chip_smoke._checker_of(model)
    return checker.input_names[1]


def every_type_gaps(j, p, textarea="lda"):
    """The JAX package's run ``j`` and the port's ``p`` (each (Dataset,
    model)): the same raw columns, the same transmogrified host slots
    (bitwise), the same kept slots. Returns the CV gaps per family and,
    under ``topics``, the LDA topics' largest absolute gap."""
    (jds, jm), (pds, pm) = j, p
    assert pds.column_names == jds.column_names
    for name in jds.column_names:
        assert_same_column(jds, pds, name)
    jfull, pfull = jm.transform(jds), pm.transform(pds)
    vec = _vector_name(jm)
    assert _vector_name(pm) == vec
    jman, pman = jfull.manifest(vec), pfull.manifest(vec)
    assert pman.to_json() == jman.to_json()
    jx, px = jfull.column(vec), pfull.column(vec)
    topic = np.asarray([c.descriptor_value is not None
                        and c.descriptor_value.startswith("topic_")
                        and c.parent_feature == "notes"
                        for c in jman.columns])
    assert topic.sum() == (8 if textarea == "lda" else 0)
    assert np.array_equal(px[:, ~topic], jx[:, ~topic], equal_nan=True)
    jc, pc = chip_smoke._checker_of(jm), chip_smoke._checker_of(pm)
    assert pc.params["keep_indices"] == jc.params["keep_indices"]
    assert pc.summary["dropped"] == jc.summary["dropped"]
    jg, pg = (chip_smoke._grid_metrics(m.selected_model().summary)
              for m in (jm, pm))
    assert sorted(pg) == sorted(jg)
    gaps = {f: float(np.max(np.abs(np.subtract(pg[f], jg[f])))) for f in jg}
    gaps["topics"] = float(np.abs(px[:, topic] - jx[:, topic]).max()
                           if topic.any() else 0.0)
    return gaps


def compare_every_type(j, p, textarea="lda"):
    """:func:`every_type_gaps`, the topics held to TOPIC_ATOL."""
    gaps = every_type_gaps(j, p, textarea)
    assert gaps["topics"] <= TOPIC_ATOL
    return gaps


class _Kept(list):
    """``chip_smoke.hist_hook``'s record, keeping only the histograms of
    the calls numbered in ``want`` (None for the others)."""

    def __init__(self, want):
        super().__init__()
        self.want = set(want)

    def append(self, h):
        super().append(h if len(self) in self.want else None)


def _parts(a, b):
    """The first (round, node) where two fits' trees split differently,
    None where they agree."""
    same = (a["feat"] == b["feat"]) & (
        (a["thr"] == b["thr"]) | (torch.isinf(a["thr"])
                                  & torch.isinf(b["thr"])))
    bad = (~same).nonzero()
    return None if len(bad) == 0 else tuple(int(v) for v in bad[0])


def cv_batch(X, y, G):
    """What the binary selector's 3-fold CV fits a family of ``G`` grid
    points on (the port's selector; the JAX package's is the same code):
    the training rows of X and y, their base weights, and the
    fold-major (fold x grid) train masks."""
    _, sel = chip_smoke._selector(X, y, ["DecisionTreeClassifier"], "cpu")
    sp = sel._make_splitter()
    idx, _ = sp.split(len(y))
    base_w, _ = sp.prepare(y[idx])
    train_m, _ = sel._make_validator()._masks(len(idx))
    return (np.ascontiguousarray(X[idx]), y[idx],
            np.asarray(base_w, np.float32), np.repeat(train_m, G, axis=0))


def trees_against_jax(family, X, y, grid):
    """``family``'s CV fits (:func:`cv_batch`: every fold and grid
    point) in both packages on the same matrix, each package's AUROC of
    each fit on its fold's validation rows: per package the CV metric
    of each grid point (the mean over folds), and per fit whether round
    0's splits agree, round 0's leaves' largest gap relative to their
    largest where they do, and the first divergence with both splits'
    gains in the port's histogram of that level
    (``chip_smoke.first_divergence``; None where the trees agree)."""
    import jax.numpy as jnp
    JM = importlib.import_module("transmogrifai_tpu.models")
    PM = importlib.import_module("transmogrifai_tpu_torch.models")
    fam_j, fam_p = JM.MODEL_FAMILIES[family], PM.MODEL_FAMILIES[family]
    PT = importlib.import_module("transmogrifai_tpu_torch.models.trees")
    JF = importlib.import_module("transmogrifai_tpu.evaluators.functional")
    PF = importlib.import_module(
        "transmogrifai_tpu_torch.evaluators.functional")
    X, y, w, train_b = cv_batch(X, y, len(grid))
    hypers = grid * (len(train_b) // len(grid))       # fold-major items
    hyper_b = {k: np.asarray([h[k] for h in hypers], np.float32)
               for k in sorted(grid[0])}
    jx = jnp.asarray(X)
    pj = fam_j._fit_grid(jx, jnp.asarray(y), jnp.asarray(w),
                         jnp.asarray(train_b),
                         {k: jnp.asarray(v) for k, v in hyper_b.items()}, 2)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}

    def port(record=None):
        with chip_smoke.hist_hook(record=record):
            return fam_p._fit_grid(
                torch.from_numpy(X), torch.from_numpy(y),
                torch.from_numpy(w), torch.from_numpy(train_b),
                {k: torch.from_numpy(v) for k, v in hyper_b.items()}, 2)
    pp = port()
    depth = fam_p.max_depth_cap
    val = w * (1.0 - train_b)
    auc_j = [float(JF.auroc(fam_j.predict_kernel(
        {k: v[g] for k, v in pj.items()}, jx, 2)[:, 1], jnp.asarray(y),
        jnp.asarray(val[g]))) for g in range(len(hypers))]
    probs = fam_p.predict_kernel(pp, torch.from_numpy(X), 2)
    auc_p = [float(PF.auroc(probs[g, :, 1], torch.from_numpy(y),
                            torch.from_numpy(val[g])))
             for g in range(len(hypers))]

    def split(params, g):
        return {k: params[k][g] for k in ("feat", "thr")}
    first = [_parts(split(pt, g), split(pp, g)) for g in range(len(hypers))]
    kept = _Kept(r * depth + (i + 1).bit_length() - 1
                 for r, i in filter(None, first))
    port(kept)                            # again, keeping those levels
    edges = PT._prep(torch.from_numpy(X), fam_p.n_bins,
                     torch.from_numpy(w))[1]
    fits = []
    for g, hyper in enumerate(hypers):
        a, b = split(pt, g), split(pp, g)
        hists = [None if h is None else h[g:g + 1] for h in kept]
        r0 = bool(torch.equal(a["feat"][0], b["feat"][0])
                  and torch.equal(a["thr"][0], b["thr"][0]))
        lj, lp = pt["leaf"][g][0], pp["leaf"][g][0]
        fits.append({"round0_splits_equal": r0,
                     "round0_leaf_rel_gap": float(
                         (lj - lp).abs().max()
                         / lp.abs().max().clamp(min=1e-30)) if r0 else None,
                     "divergence": chip_smoke.first_divergence(
                         (a, hists), (b, hists), edges, hyper, depth)})
    G = len(grid)
    return {"jax": [float(np.mean(auc_j[j::G])) for j in range(G)],
            "port": [float(np.mean(auc_p[j::G])) for j in range(G)],
            "fits": fits}


def _gap(a, b) -> float:
    return float(np.abs(np.subtract(a, b)).max())


def selector_against_jax(j):
    """The JAX package's run ``j`` (Dataset, model), on its own checked
    matrix: per family the JAX workflow's CV metrics and the port
    selector's; for DT and GBT also both packages' plain CV fits
    (:func:`trees_against_jax`)."""
    jds, jm = j
    X, y = chip_smoke.checked_matrix(jm, jds, "label")
    summ = jm.selected_model().summary
    grids = {r["family"]: r["grid"] for r in summ["validationResults"]}
    want = chip_smoke._grid_metrics(summ)
    ds, sel = chip_smoke._selector(X, y, CANDIDATES[:1], "cpu")
    out = {"LogisticRegression": {
        "jax_workflow": want["LogisticRegression"],
        "port_selector": sel.fit(ds).summary["validationResults"][0][
            "gridMetrics"]}}
    for fam in ("DecisionTreeClassifier", "GBTClassifier"):
        out[fam] = dict(trees_against_jax(fam, X, y, grids[fam]),
                        jax_workflow=want[fam],
                        port_selector=chip_smoke.tree_cv(
                            fam, X, y, "cpu", {})["gridMetrics"])
    return out


def assert_selector_as_jax(j):
    """:func:`selector_against_jax`, held: LR's CV metrics within 1e-6
    of the JAX workflow's; the port's DT and GBT selector metrics its
    plain CV fits'; DT's fits JAX's, tree for tree and metric for
    metric; GBT's agree with JAX's or part first at a near tie (round
    0's leaves within LEAF_RTOL where round 0's splits agree), the CV
    metrics within GBT_CV_TOL. Returns the readings."""
    out = selector_against_jax(j)
    lr = out["LogisticRegression"]
    assert _gap(lr["port_selector"], lr["jax_workflow"]) <= LR_CV_ATOL
    for fam in ("DecisionTreeClassifier", "GBTClassifier"):
        r = out[fam]
        assert _gap(r["port_selector"], r["port"]) <= LR_CV_ATOL
        for d in r["fits"]:
            if fam == "DecisionTreeClassifier":
                assert d["round0_splits_equal"] and d["divergence"] is None
            if d["round0_splits_equal"]:
                assert d["round0_leaf_rel_gap"] <= LEAF_RTOL
            if d["divergence"] is not None:
                assert d["divergence"]["gap_cpu"] <= GBT_GAP_RTOL, d
        assert _gap(r["port"], r["jax"]) <= (
            LR_CV_ATOL if fam == "DecisionTreeClassifier" else GBT_CV_TOL)
    return out


@pytest.fixture(scope="module")
def every_type_runs():
    return _train(J), _train(P)


def test_every_type_workflow_matches_jax_on_the_cpu(every_type_runs):
    j, p = every_type_runs
    gaps = compare_every_type(j, p)
    assert gaps["LogisticRegression"] <= LR_WORKFLOW_TOL
    assert gaps["DecisionTreeClassifier"] <= TREE_CV_TOL
    assert gaps["GBTClassifier"] <= TREE_CV_TOL
    assert_selector_as_jax(j)
    jw, pw = (m.selected_model().summary["bestModel"] for _, m in (j, p))
    assert (pw["family"], pw["hyper"]) == (jw["family"], jw["hyper"])
    # the seller column: detected and removed in both
    ji, pi = (m.model_insights()["sensitiveFeatureInformation"]
              for _, m in (j, p))
    assert pi == ji and pi[0]["actionTaken"] == "removed"


def test_host_stage_workflow_matches_jax_bitwise_inputs():
    cands = CANDIDATES + [["RandomForestClassifier", None]]
    j = _train(J, 600, cands, textarea="smart")
    p = _train(P, 600, cands, textarea="smart")
    gaps = compare_every_type(j, p, textarea="smart")
    assert gaps["LogisticRegression"] <= LR_CV_ATOL
    assert gaps["DecisionTreeClassifier"] <= LR_CV_ATOL
    # the same matrix: the workflow's GBT gap is its CV fits' gap
    gbt = assert_selector_as_jax(j)["GBTClassifier"]
    assert gaps["GBTClassifier"] == _gap(gbt["port_selector"],
                                         gbt["jax_workflow"])
    jg, pg = (chip_smoke._grid_metrics(m.selected_model().summary)
              for _, m in (j, p))
    rf = "RandomForestClassifier"
    assert abs(np.mean(pg[rf]) - np.mean(jg[rf])) <= RF_MEAN_TOL


def _probs(model, ds):
    name = model.result_features[0].name
    return np.asarray([r["probability_1"]
                       for r in model.score(ds).column(name)])


def test_every_type_model_crosses_packages_both_ways(every_type_runs,
                                                     tmp_path):
    (jds, jm), (pds, pm) = every_type_runs
    jm.save(str(tmp_path / "jax"))
    pm.save(str(tmp_path / "port"))
    into_port = PW.WorkflowModel.load(str(tmp_path / "jax"),
                                              device="cpu")
    into_jax = JW.WorkflowModel.load(str(tmp_path / "port"))
    np.testing.assert_allclose(_probs(into_port, pds), _probs(jm, jds),
                               rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(_probs(into_jax, jds), _probs(pm, pds),
                               rtol=0, atol=SCORE_ATOL)
    kinds = {type(st).__name__ for st in into_port.stages}
    assert {"LDAModel", "EmailToPickList", "UrlToDomain",
            "IsValidPhoneTransformer", "MimeTypeDetector",
            "DateListVectorizer", "CountVectorizerModel", "RealMapModel",
            "GeolocationMapModel", "TextMapPivotModel",
            "SmartTextMapModel", "DateMapModel"} <= kinds


def test_fused_scorer_host_stages_match_jax(every_type_runs):
    (_, jm), (_, pm) = every_type_runs
    js = jm.compile_scoring()
    ps = pm.compile_scoring(device="cpu")
    assert [type(s).__name__ for s in ps.host_stages] == \
        [type(s).__name__ for s in js.host_stages]
    assert sorted(ps.device_stage_by_output) == \
        sorted(js.device_stage_by_output)


def test_checked_in_jax_artifact_loads_and_scores_in_both():
    base = torch_artifact.ARTIFACT
    rows = json.load(open(os.path.join(base, "rows.json")))
    want = np.asarray(json.load(open(os.path.join(base, "scores.json"))))
    jm = JW.WorkflowModel.load(os.path.join(base, "model"))
    assert torch_artifact.probabilities(jm, rows) == list(want)
    pm = PW.WorkflowModel.load(os.path.join(base, "model"),
                                       device="cpu")
    got = np.asarray(torch_artifact.probabilities(pm, rows))
    np.testing.assert_allclose(got, want, rtol=chip_smoke.ARTIFACT_RTOL)
    assert "rawFeatureFilter" in pm.train_summaries
    out = chip_smoke.artifact_part("cpu")
    assert out["max_rel_err"] <= chip_smoke.ARTIFACT_RTOL


def test_checked_in_jax_artifact_is_what_the_helper_writes(tmp_path):
    scores = torch_artifact.write(str(tmp_path / "a"))
    want = json.load(open(os.path.join(torch_artifact.ARTIFACT,
                                       "scores.json")))
    assert scores == want
    assert json.load(open(tmp_path / "a" / "rows.json")) == json.load(
        open(os.path.join(torch_artifact.ARTIFACT, "rows.json")))


# -- planted faults ---------------------------------------------------------

def _small_pair(rows=300, fault=None, monkeypatch=None):
    cands = [["LogisticRegression", {"regParam": [0.1]}]]
    j = _train(J, rows, cands)
    if fault is not None:
        fault(monkeypatch)
    p = _train(P, rows, cands)
    return j, p


def test_small_every_type_pair_agrees():
    j, p = _small_pair()
    assert compare_every_type(j, p)["LogisticRegression"] <= \
        LR_WORKFLOW_TOL


def _reverse_map_keys(monkeypatch):
    from transmogrifai_tpu_torch.ops import maps
    orig = maps.RealMapVectorizer.fit_fn

    def fit_fn(self, ds):
        out = orig(self, ds)
        return dict(out, keys=list(reversed(out["keys"])),
                    fills=list(reversed(out["fills"])))
    monkeypatch.setattr(maps.RealMapVectorizer, "fit_fn", fit_fn)


def _one_e_step_less(monkeypatch):
    from transmogrifai_tpu_torch.ops import lda
    orig = lda._e_step
    monkeypatch.setattr(lda, "_e_step",
                        lambda c, b, a, n: orig(c, b, a, n - 1))


@pytest.mark.parametrize("fault", [_reverse_map_keys, _one_e_step_less],
                         ids=["map_key_order", "lda_e_step"])
def test_planted_fault_fails_the_comparison(fault, monkeypatch):
    j, p = _small_pair(fault=fault, monkeypatch=monkeypatch)
    with pytest.raises(AssertionError):
        compare_every_type(j, p)
    if fault is _one_e_step_less:       # past the limit by far
        assert every_type_gaps(j, p)["topics"] > 100 * TOPIC_ATOL


def test_lda_row_and_batch_topics_agree_to_rounding_in_both():
    """One document alone and inside a batch gives topics equal to the
    last bits only, in both packages (the matrix products round by the
    batch): so a tree that splits a topic at a bin edge can score a row
    alone differently from the batch (ROADMAP queue 3)."""
    words = torch_artifact._SPORTS + torch_artifact._COOKING
    docs = [" ".join(np.random.default_rng(i).choice(words, 12))
            for i in range(64)]
    gaps = {}
    for pkg in (J, P):
        reset_uids()
        tk = importlib.import_module(f"{pkg.__name__}.testkit")
        ops = importlib.import_module(f"{pkg.__name__}.ops")
        ds, f = tk.TestFeatureBuilder.single("d", pkg.types.TextArea, docs)
        est = ops.OpLDA(k=4, vocab_size=32, em_iters=5).set_input(f)
        if pkg is P:
            est.device = "cpu"
        model = est.fit(ds)
        batch = model.transform(ds).column(model.output.name)
        rows = np.stack([model.transform_value(pkg.types.TextArea(d)).value
                         for d in docs])
        gaps[pkg.__name__] = float(np.abs(rows - batch).max())
    assert max(gaps.values()) <= 1e-6


# -- class keys of the lifted modules ---------------------------------------

LIFTED = {
    "ops.parsers": "StringIndexerModel", "ops.maps": "RealMapModel",
    "ops.numeric": "BucketizerModel", "ops.text_advanced":
        "CountVectorizerModel", "ops.dsl": "ArithmeticTransformer",
    "ops.analyzers": None, "ops.ner": "NameEntityRecognizer",
    "ops.ner_data": None, "ops.lda": "LDAModel",
    "stages.wrappers": "WrappedModel", "filters": None, "testkit": None,
    "models.ft_transformer": "OpFTTransformerClassifier"}


@pytest.mark.parametrize("module,cls", sorted(LIFTED.items()))
def test_lifted_module_resolves_its_jax_keys(module, cls):
    from transmogrifai_tpu_torch.stages import base
    port = importlib.import_module(f"transmogrifai_tpu_torch.{module}")
    ref = importlib.import_module(f"transmogrifai_tpu.{module}")
    if cls is None:      # no stage class: the module itself is there
        public = [n for n in dir(ref) if not n.startswith("_")]
        assert all(hasattr(port, n) for n in public), module
        return
    got = base.resolve_stage_class(f"transmogrifai_tpu.{module}.{cls}")
    assert got is getattr(port, cls)
    assert base.stage_class_key(got) == f"transmogrifai_tpu.{module}.{cls}"


# -- the Feature DSL ----------------------------------------------------------

DSL = [("Text", "tokenize", {}), ("PickList", "pivot", {}),
       ("Text", "detect_languages", {}), ("Text", "text_len", {}),
       ("Real", "bucketize", {"splits": [0.0, 1.0]}),
       ("Real", "zscore", {}), ("Text", "occurs", {}),
       ("Text", "index", {}), ("Text", "ngram", {"n": 2}),
       ("Phone", "is_valid_phone", {}), ("Email", "email_domain", {}),
       ("URL", "url_domain", {}), ("Real", "fill_missing_with_mean", {}),
       ("Real", "scale", {"scaling_type": "log"}),
       ("Date", "to_time_period", {"period": "HourOfDay"})]


def _dsl_values(kind, rng, n=40):
    if kind in ("Real",):
        return [None if rng.random() < 0.1 else float(v)
                for v in rng.lognormal(size=n)]
    if kind == "Date":
        return [int(v) for v in rng.integers(1.5e12, 1.6e12, n)]
    if kind == "Phone":
        return [["(650) 123-4567", "12", None][int(i)]
                for i in rng.integers(0, 3, n)]
    if kind == "Email":
        return [f"a{i}@d{int(rng.integers(0, 3))}.com" for i in range(n)]
    if kind == "URL":
        return [f"https://d{int(rng.integers(0, 3))}.org/x"
                for i in range(n)]
    if kind == "PickList":
        return [["a", "b", None][int(i)] for i in rng.integers(0, 3, n)]
    return [" ".join(rng.choice(["la", "casa", "the", "house", "dog"], 4))
            for _ in range(n)]


@pytest.mark.parametrize("kind,verb,kw", DSL,
                         ids=[v for _k, v, _kw in DSL])
def test_dsl_verb_builds_the_jax_stage(kind, verb, kw):
    from torch_parity import build
    vals = _dsl_values(kind, np.random.default_rng(1))
    outs = []
    for pkg in ("transmogrifai_tpu", "transmogrifai_tpu_torch"):
        reset_uids()
        ds, feats = build(pkg, {"x": (kind, vals)})
        f = getattr(feats["x"], verb)(**kw)
        st = f.origin_stage
        base = importlib.import_module(f"{pkg}.stages.base")
        model = st.fit(ds) if isinstance(st, base.Estimator) else st
        outs.append((model, model.transform(ds), f.name))
    (jm, jout, jn), (pm, pout, pn) = outs
    assert pn == jn
    assert stage_doc(pm) == stage_doc(jm)
    assert_same_column(jout, pout, jn)


def test_dsl_arithmetic_matches_jax():
    from torch_parity import build
    rng = np.random.default_rng(2)
    cols = {"a": ("Real", [float(v) for v in rng.normal(size=30)]),
            "b": ("Real", [float(v) for v in rng.normal(size=30)])}
    outs = []
    for pkg in ("transmogrifai_tpu", "transmogrifai_tpu_torch"):
        reset_uids()
        ds, feats = build(pkg, cols)
        a, b = feats["a"], feats["b"]
        res = [a + b, a - b, a * b, a / b, a * 2.0, 3.0 - a]
        for f in res:
            ds = f.origin_stage.transform(ds)
        outs.append((ds, [f.name for f in res]))
    (jds, jn), (pds, pn) = outs
    assert pn == jn
    for name in jn:
        assert_same_column(jds, pds, name)


MIRROR = load_mirror("test_vectorizers.py")


@pytest.mark.parametrize("name,kwargs", [
    c for c in mirror_cases(MIRROR)
    if c.values[0] == "test_transmogrify_textarea_routing_knob"])
def test_textarea_routing_case_on_the_port(name, kwargs, request,
                                           port_on_cpu):
    run_mirror_case(MIRROR, name, kwargs, request)
