"""The learned autotuner on the port (``transmogrifai_tpu_torch/autotune``).

Two halves:

* the JAX package's ``tests/test_autotune.py`` case for case through
  ``tests/torch_mirror.py`` where the case is the same contract on the
  port: the strict knobs and every bucket-ladder case (the padded-rows
  objective against ``FusedScorer._bucket_slices``, the proposal's
  determinism and never-worse guard, the mix harvesters, the refused
  proposal, the engine-swap path and the end-to-end rollout drill, the
  last under a time limit of its own);
* port-written counterparts of the cases keyed by the TPU's launch knobs
  (``block_n``, ``rows_per_step``, ``double_buffer``) and of the learned
  serving autotuner's block of ``tests/test_fused_serving.py``: the
  cost models over the Hopper kernels' own launch choices, their
  artifacts, the refusal of JAX-saved models and TPU measurements, the
  hooks, and the candidate screens in lockstep with the launch rules.

SKIP names each JAX case left out and why; the card's side (every
candidate bitwise, the hooks firing) is in ``tests/test_torch_cuda.py``.
"""
import json
import os
import threading

import numpy as np
import pytest

from torch_mirror import (load_mirror, mirror_cases, mirror_fixtures,  # noqa
                          one_torch_thread, port_on_cpu, run_mirror_case)
from transmogrifai_tpu_torch import autotune as at
from transmogrifai_tpu_torch.autotune import costmodel as acm
from transmogrifai_tpu_torch.models import kernels as tk
from transmogrifai_tpu_torch.models import serving_kernels as sk

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MIRROR = load_mirror("test_autotune.py")
globals().update(mirror_fixtures(MIRROR))

#: case id -> why the port does not run it as the JAX test wrote it
SKIP = {
    "test_cost_model_determinism_and_choice":
        "asserts the TPU's double_buffer choice; the port's counterpart "
        "is test_cost_model_is_deterministic below",
    "test_cost_model_static_default_always_candidate":
        "keyed by the TPU's block_n / double_buffer; counterpart "
        "test_static_default_is_always_a_candidate",
    "test_cost_model_json_roundtrip_and_feature_drift":
        "format 99 aside, the same contract; counterpart "
        "test_cost_model_json_round_trip_and_refusals",
    "test_harvester_drops_structured_skips_without_prose_parsing":
        "its records are TPU-keyed (block_n, block_<n>_sub_<k>_ms), "
        "which the port refuses; counterpart "
        "test_harvester_drops_structured_skips",
    "test_kernel_launch_hook_off_modelless_and_cached":
        "asserts the TPU's double_buffer choice; counterpart "
        "test_kernel_launch_hook_off_modelless_and_cached",
    "test_autotuned_kernel_stays_parity_correct":
        "runs the Pallas kernel; the port's kernel runs only on the "
        "card (tests/test_torch_cuda.py: every candidate bitwise, the "
        "hooks firing)",
}
#: the drill's own time limit (s): it drives a 2-replica fleet for
#: several seconds and was unsteady under many workers in the JAX suite
DRILL = "test_bucket_retune_end_to_end_drill"
DRILL_LIMIT_S = 240.0


@pytest.mark.parametrize("name,kwargs", [
    p for p in mirror_cases(MIRROR) if p.id not in SKIP])
def test_autotune_case_on_the_port(name, kwargs, request, port_on_cpu):
    if name != DRILL:
        run_mirror_case(MIRROR, name, kwargs, request)
        return
    errors = []

    def run():
        try:
            run_mirror_case(MIRROR, name, kwargs, request)
        except BaseException as e:          # re-raised below
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(DRILL_LIMIT_S)
    assert not t.is_alive(), f"the drill ran past {DRILL_LIMIT_S} s"
    if errors:
        raise errors[0]


# ---------------------------------------------------------------------------
# the histogram's cost model (port-written, at the port's config keys)
# ---------------------------------------------------------------------------

SHAPE = {"G": 4, "n": 20_000, "d": 7, "B": 8, "S": 3, "m": 4}


def _synthetic_measurements():
    """A measurement set with a known structure: the sort's serial walk
    (its chunk rows) dominates, so the smallest chunk measures
    fastest."""
    out = []
    for shape in (SHAPE, dict(SHAPE, n=40_000, G=2)):
        for cfg in at.candidate_configs(shape, max_block=2048):
            ms = 0.2 * cfg["sort_chunk_rows"] / 1e3 + 0.01
            out.append({"shape": shape, "config": cfg, "ms": float(ms)})
    return out


def test_cost_model_is_deterministic():
    """Same measurements in ANY order -> bit-identical coefficients and
    the same chosen config; the choice follows the synthetic physics."""
    meas = _synthetic_measurements()
    m1 = at.KernelCostModel.fit(meas)
    rng = np.random.default_rng(7)
    m2 = at.KernelCostModel.fit([meas[i] for i in rng.permutation(len(meas))])
    assert np.array_equal(m1.coef, m2.coef)
    c1, ms1 = m1.choose_config(SHAPE)
    assert (c1, ms1) == m2.choose_config(SHAPE)
    assert c1 == acm.executed_config(SHAPE, {"sort_chunk_rows": 256})


@pytest.mark.parametrize("shape", [
    SHAPE, dict(SHAPE, n=300), dict(SHAPE, n=1, G=1, m=1),
    {"G": 16, "n": 200_000, "d": 28, "B": 32, "S": 5, "m": 8}])
def test_static_default_is_always_a_candidate(shape):
    """The static launch, as executed at the shape, is always in the
    candidate set, so the chooser never predicts worse than it."""
    cands = at.candidate_configs(shape)
    keys = [acm.config_key(c) for c in cands]
    static = acm.executed_config(shape, acm.STATIC_DEFAULT_CONFIG)
    assert acm.config_key(static) in keys
    assert len(set(keys)) == len(keys) and keys == sorted(keys)
    model = at.KernelCostModel.fit(_synthetic_measurements())
    _chosen, predicted = model.choose_config(shape)
    assert predicted <= model.predict_ms(shape, static)


def test_cost_model_json_round_trip_and_refusals():
    model = at.KernelCostModel.fit(_synthetic_measurements())
    doc = json.loads(json.dumps(model.to_json()))
    assert doc["format"] == "cuda-1"
    back = at.KernelCostModel.from_json(doc)
    assert np.array_equal(back.coef, model.coef)
    assert back.choose_config(SHAPE) == model.choose_config(SHAPE)
    with pytest.raises(ValueError, match="feature set drifted"):
        at.KernelCostModel.from_json(dict(doc, features=["const", "x"]))
    with pytest.raises(ValueError, match="format"):
        at.KernelCostModel.from_json(dict(doc, format=99))
    # the serving model refuses the histogram's artifact and vice versa
    with pytest.raises(ValueError, match="format"):
        at.ServingCostModel.from_json(doc)
    sdoc = at.ServingCostModel.fit(_serve_measurements(SERVE)).to_json()
    with pytest.raises(ValueError, match="format"):
        at.KernelCostModel.from_json(sdoc)


def test_jax_saved_cost_models_are_refused(tmp_path):
    """A cost model the JAX package saved (fitted on TPU measurements of
    VMEM blocks) cannot steer a Hopper launch: loading it raises,
    naming the JAX format."""
    from transmogrifai_tpu.autotune import (KernelCostModel,
                                            ServingCostModel)
    from transmogrifai_tpu.autotune import candidate_configs
    from transmogrifai_tpu.autotune import serve_candidate_configs
    shape = {"G": 4, "n": 2000, "d": 7, "B": 8, "S": 3, "m": 4}
    kpath, spath = str(tmp_path / "k.json"), str(tmp_path / "s.json")
    KernelCostModel.fit([
        {"shape": shape, "config": c, "ms": 1.0 + 1e-3 * c["block_n"]}
        for c in candidate_configs(shape, max_block=512)]).save(kpath)
    sshape = {"K": 4, "n": 256, "p": 32, "L": 1}
    ServingCostModel.fit([
        {"shape": sshape, "config": c, "ms": 0.1 + 1e-4 * c["block_rows"]}
        for c in serve_candidate_configs(sshape)]).save(spath)
    with pytest.raises(ValueError, match="format 1: a JAX-package "
                                         "KernelCostModel"):
        at.KernelCostModel.load(kpath)
    with pytest.raises(ValueError, match="'serve-1': a JAX-package "
                                         "ServingCostModel"):
        at.ServingCostModel.load(spath)


def test_tpu_measurements_are_refused():
    """The repo's BENCH_CAPTURE.json holds the TPU's hist_block_tune
    sweep: harvesting it raises naming its block timings; a structured
    measurement keyed by the TPU's knobs raises naming them, in the
    harvesters and in the fit; a record measured on another backend
    raises naming it."""
    with open(os.path.join(_REPO, "BENCH_CAPTURE.json")) as fh:
        capture = json.load(fh)
    with pytest.raises(ValueError, match=r"TPU block timings \['block_"):
        at.measurements_from_capture(capture)
    tpu = {"shape": SHAPE, "config": {"block_n": 512, "rows_per_step": 1,
                                      "double_buffer": True}, "ms": 0.5}
    with pytest.raises(ValueError, match=r"\['block_n', 'double_buffer', "
                                         r"'rows_per_step'\]"):
        at.measurements_from_tune_record({"measurements": [tpu]})
    with pytest.raises(ValueError, match="TPU kernels' launch knobs"):
        at.KernelCostModel.fit([tpu])
    with pytest.raises(ValueError, match="backend 'tpu'"):
        at.serve_measurements_from_tune_record(
            {"backend": "tpu", "measurements": []})


def test_harvester_drops_structured_skips():
    """Structured measurements pass through, skip entries are dropped
    by key; the capture walk reads current + ok _history entries."""
    good = {"shape": SHAPE, "config": dict(acm.STATIC_DEFAULT_CONFIG),
            "ms": 0.5}
    record = {"backend": "cuda", "measurements": [
        good, {"shape": SHAPE, "config": dict(acm.STATIC_DEFAULT_CONFIG),
               "skipped": "refused", "error_type": "ValueError"},
        "not a measurement"]}
    meas = at.measurements_from_tune_record(record)
    assert meas == [good]
    capture = {"hist_block_tune": {"ok": True, "result": record},
               "_history": {"kernel_autotune@1": {"ok": True,
                                                  "result": record},
                            "kernel_autotune@2": {"ok": False,
                                                  "result": record}}}
    assert len(at.measurements_from_capture(capture)) == 2


def test_kernel_launch_hook_off_modelless_and_cached(tmp_path, monkeypatch):
    for name in list(os.environ):
        if name.startswith("TM_AUTOTUNE"):
            monkeypatch.delenv(name)
    at.reset_autotuner()
    assert at.kernel_launch_config(**SHAPE) is None       # off by default
    monkeypatch.setenv("TM_AUTOTUNE", "1")
    # the knobs resolve once: the change counts after a reset
    assert at.kernel_launch_config(**SHAPE) is None
    at.reset_autotuner()
    assert at.kernel_launch_config(**SHAPE) is None       # no model
    model = at.KernelCostModel.fit(_synthetic_measurements())
    path = str(tmp_path / "cost_model.json")
    model.save(path)
    monkeypatch.setenv("TM_AUTOTUNE_MODEL", path)
    at.reset_autotuner()
    try:
        cfg = at.kernel_launch_config(**SHAPE)
        assert cfg == model.choose_config(SHAPE)[0]
        assert at.kernel_launch_config(**SHAPE) == cfg     # cached
        log = at.kernel_dispatch_log()
        assert len(log) == 1 and log[0]["shape"] == SHAPE
        assert log[0]["predicted_ms"] == pytest.approx(
            model.choose_config(SHAPE)[1])
        # the model reloads on an mtime change; decided shapes keep
        # their decision, a new shape takes the new model
        flat = at.KernelCostModel(coef=np.zeros_like(model.coef))
        flat.save(path)
        os.utime(path, (1, 1))
        other = dict(SHAPE, n=30_000)
        assert at.kernel_launch_config(**SHAPE) == cfg
        assert at.kernel_launch_config(**other) == min(
            at.candidate_configs(other), key=acm.config_key)
        # TM_AUTOTUNE_MAX_BLOCK caps the sort's chunk rows
        monkeypatch.setenv("TM_AUTOTUNE_MAX_BLOCK", "256")
        at.reset_autotuner()
        third = dict(SHAPE, n=50_000)
        assert at.kernel_launch_config(**third)["sort_chunk_rows"] <= 1024
        assert {c["sort_chunk_rows"] for c in at.candidate_configs(
            third, max_block=256)} <= {256, 1024}
    finally:
        at.reset_autotuner()
    assert at.kernel_dispatch_log() == []


def test_kernel_hook_is_recorded_in_the_flight_recorder(tmp_path,
                                                        monkeypatch):
    from transmogrifai_tpu_torch.telemetry.recorder import RECORDER
    path = str(tmp_path / "m.json")
    at.KernelCostModel.fit(_synthetic_measurements()).save(path)
    monkeypatch.setenv("TM_AUTOTUNE", "1")
    monkeypatch.setenv("TM_AUTOTUNE_MODEL", path)
    at.reset_autotuner()
    seq0 = RECORDER.total
    try:
        for n in (20_000, 20_000, 30_000):
            at.kernel_launch_config(**dict(SHAPE, n=n))
    finally:
        at.reset_autotuner()
    ev = [e for e in RECORDER.events(subsystem="autotune")
          if e["seq"] > seq0]
    assert [e["event"] for e in ev] == ["kernel_config"] * 2
    assert set(acm.CONFIG_KEYS) <= set(ev[0]["attrs"])


@pytest.mark.parametrize("shape", [
    SHAPE, {"G": 16, "n": 200_000, "d": 28, "B": 32, "S": 5, "m": 8},
    {"G": 192, "n": 50_000, "d": 28, "B": 32, "S": 5, "m": 16},
    {"G": 2, "n": 3_001, "d": 37, "B": 300, "S": 21, "m": 5}])
def test_candidates_are_in_lockstep_with_launch_plan(shape):
    """The screen runs the launch rule itself: every candidate is a
    launch ``launch_plan`` takes, labelled as it executes (each
    candidate is its own executed config), with distinct executions;
    a shape the kernel refuses has no candidate, as launch_plan
    raises."""
    G, n, d, B, S, m = acm.shape_key(shape)
    cands = at.candidate_configs(shape)
    static = tk.launch_plan(G, n, d, S, m, B)
    for c in cands:
        plan = tk.launch_plan(G, n, d, S, m, B, c)
        assert acm.executed_config(shape, c) == c
        assert (plan["sort_chunk_rows"], plan["reduce_blocks"]) == tuple(
            c[k] for k in acm.CONFIG_KEYS)
        # no choice moves the histogram pass's own grid
        assert (plan["blocks"], plan["warps"]) == (static["blocks"],
                                                   static["warps"])
    refused = dict(shape, m=tk.MAX_NODES + 1)
    with pytest.raises(ValueError, match="nodes exceeds"):
        tk.launch_plan(G, n, d, S, tk.MAX_NODES + 1, B)
    assert at.candidate_configs(refused) == []


def test_launch_config_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="unknown launch config"):
        tk.launch_config({"features_per_warp": 4})
    with pytest.raises(ValueError, match=">= 1"):
        tk.launch_config({"sort_chunk_rows": 0})
    with pytest.raises(ValueError, match="unknown launch config"):
        tk.launch_config({"block_n": 512})
    with pytest.raises(ValueError, match="block_rows"):
        sk.launch_config({"block_rows": 12})
    assert tk.launch_config(None) == tk.STATIC_LAUNCH_CONFIG
    assert sk.launch_config(None) == sk.STATIC_LAUNCH_CONFIG


def test_cpu_wrappers_take_a_config_and_stay_the_plain_version():
    """On the CPU the wrappers are the plain versions, with or without
    a launch config (checked), and the hooks are not consulted."""
    import torch
    rng = np.random.default_rng(0)
    bins = torch.from_numpy(rng.integers(0, 8, (300, 7)).astype(np.int32))
    stats = torch.from_numpy(rng.normal(size=(2, 300, 3)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 4, (2, 300)).astype(np.int32))
    ref = tk.histogram_torch(bins, stats, pos, 4, 8)
    for cfg in at.candidate_configs({"G": 2, "n": 300, "d": 7, "B": 8,
                                     "S": 3, "m": 4})[:4]:
        assert torch.equal(tk.histogram_grid(bins, stats, pos, 4, 8,
                                             config=cfg), ref)
    with pytest.raises(ValueError, match="reduce_blocks"):
        tk.histogram_grid(bins, stats, pos, 4, 8,
                          config={"reduce_blocks": 0})


# ---------------------------------------------------------------------------
# the learned serving autotuner (tests/test_fused_serving.py's block,
# port-written at the scorer's own launch choice)
# ---------------------------------------------------------------------------

SERVE = {"K": 4, "n": 1000, "p": 37, "L": 2}


def _serve_measurements(shape, *, weight_on=None):
    out = []
    for cfg in at.serve_candidate_configs(shape):
        bn = cfg["block_rows"]
        m = {"shape": dict(shape), "config": dict(cfg),
             "ms": 0.05 + 40.0 / bn + 0.0002 * bn}
        if weight_on is not None and bn == weight_on:
            m["weight"] = 10.0
        out.append(m)
    return out


def test_serve_candidates_screened_and_include_default():
    """Candidates are rows-a-block the C entry takes (multiples of a
    block's warps), at most TM_AUTOTUNE_MAX_BLOCK, deduped by the grid
    each executes, and always hold the static launch."""
    cands = at.serve_candidate_configs(SERVE)
    blocks = [c["block_rows"] for c in cands]
    assert blocks == sorted(blocks) and len(set(blocks)) == len(blocks)
    for b in blocks:
        assert b % sk.WARPS_PER_BLOCK == 0 and 8 <= b <= 4096
        sk.launch_config({"block_rows": b})
    assert sk.STATIC_LAUNCH_CONFIG["block_rows"] in blocks
    grids = [acm.serve_grid(SERVE, c) for c in cands]
    assert len(set(grids)) == len(grids) and grids[-1] == 1
    assert max(c["block_rows"] for c in at.serve_candidate_configs(
        SERVE, max_block=64)) == 64


@pytest.mark.parametrize("n,occ", [(64, (132, 8)), (8192, (132, 4)),
                                   (100_000, (132, 2)), (5, (132, 8))])
def test_serve_screen_is_in_lockstep_with_the_launch_rule(n, occ):
    """Given the grid each rows-a-block launches (on the card the C
    entry's own answer, ``launch_blocks_on_card``; here a rule of the
    same form: past one block an SM, at most SMs x resident blocks) the
    screen keeps one candidate a distinct grid, the smallest
    rows-a-block naming it, and asks for no other grid."""
    sms, per_sm = occ

    def grid(br):
        asked.append(br)
        blocks = -(-n // br)
        return min(blocks, sms * per_sm) if blocks > sms else blocks

    asked = []
    cands = at.serve_candidate_configs(dict(SERVE, n=n), grid=grid)
    every = [8 * 2 ** i for i in range(10)]
    assert asked == every
    grids = [grid(c["block_rows"]) for c in cands]
    assert len(set(grids)) == len(grids)
    assert set(grids) == {grid(b) for b in every}
    assert cands[0] == sk.STATIC_LAUNCH_CONFIG
    for c, g in zip(cands, grids):
        assert c["block_rows"] == min(b for b in every if grid(b) == g)
    if n > sms * per_sm * 8:
        assert grids[0] == sms * per_sm      # capped


def test_serving_cost_model_fit_is_deterministic_and_weighted():
    ms = _serve_measurements(SERVE)
    m1 = at.ServingCostModel.fit(ms)
    m2 = at.ServingCostModel.fit(list(reversed(ms)))
    assert np.array_equal(m1.coef, m2.coef)
    choice, predicted = m1.choose_config(SERVE)
    assert choice in [c["config"] for c in ms] and np.isfinite(predicted)
    mw = at.ServingCostModel.fit(_serve_measurements(SERVE, weight_on=32))
    assert not np.array_equal(m1.coef, mw.coef)
    with pytest.raises(ValueError, match="weights"):
        bad = _serve_measurements(SERVE)
        bad[0]["weight"] = -1.0
        at.ServingCostModel.fit(bad)
    with pytest.raises(ValueError, match="zero measurements"):
        at.ServingCostModel.fit([])


def test_serving_model_artifact_refusals(tmp_path):
    model = at.ServingCostModel.fit(_serve_measurements(SERVE))
    path = str(tmp_path / "serve.json")
    model.save(path)
    assert np.array_equal(at.ServingCostModel.load(path).coef, model.coef)
    with pytest.raises(ValueError, match="format"):
        at.KernelCostModel.load(path)
    doc = model.to_json()
    assert doc["format"] == "serve-cuda-1"
    with pytest.raises(ValueError, match="drifted"):
        at.ServingCostModel.from_json(dict(doc, features=["const", "x"]))


def test_serving_launch_config_hook_caches_and_resets(tmp_path,
                                                      monkeypatch):
    path = str(tmp_path / "serve.json")
    at.ServingCostModel.fit(_serve_measurements(SERVE)).save(path)
    for name in list(os.environ):
        if name.startswith("TM_AUTOTUNE"):
            monkeypatch.delenv(name)
    at.reset_autotuner()
    asked = []

    def grid(br):
        asked.append(br)
        return min(-(-SERVE["n"] // br), 64)

    assert at.serving_launch_config(grid=grid, **SERVE) is None   # off
    monkeypatch.setenv("TM_AUTOTUNE", "1")
    monkeypatch.setenv("TM_AUTOTUNE_SERVING_MODEL", path)
    # the knobs resolve once: a changed variable counts after a reset
    assert at.serving_launch_config(grid=grid, **SERVE) is None
    at.reset_autotuner()
    try:
        first = at.serving_launch_config(grid=grid, **SERVE)
        assert first is not None and first["block_rows"] % 8 == 0
        decided = len(asked)
        assert decided > 0            # the grid is asked at the decision
        assert at.serving_launch_config(grid=grid, **SERVE) == first
        assert len(asked) == decided  # and not again for a cached shape
        log = at.serving_dispatch_log()
        assert len(log) == 1 and log[0]["config"] == first
        assert log[0]["shape"] == SERVE
        assert log[0]["blocks"] == grid(first["block_rows"])
    finally:
        at.reset_autotuner()
    assert at.serving_dispatch_log() == []


def test_serve_measurement_harvest_paths():
    rec = {"backend": "cuda", "measurements": [
        {"shape": {"K": 2, "n": 64, "p": 8, "L": 1},
         "config": {"block_rows": 32}, "ms": 0.4, "weight": 3.0},
        {"skipped": "refused", "error_type": "ValueError"},
        {"shape": {"K": 2, "n": 64, "p": 8, "L": 1},
         "config": {"block_rows": 64}, "ms": 0.3},
    ]}
    got = at.serve_measurements_from_tune_record(rec)
    assert len(got) == 2 and got[0]["weight"] == 3.0
    cap = {"fused_serving": {"ok": True, "result": rec},
           "_history": {"fused_serving@1": {"ok": True, "result": rec},
                        "fused_serving@2": {"ok": False, "result": rec},
                        "multi_model_load@1": {"ok": True, "result": rec}}}
    harvested = at.serve_measurements_from_capture(cap)
    assert len(harvested) == 4
    json.dumps(harvested)
