"""The harness finds every configuration, mix, limits file and metric
reader by the names BENCHMARK.json gives, and the file keeps to the
benchmark's contract."""
import importlib
import json
import os
import re

import pytest

from portbench import run

ROOT = run.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_by_name(cell):
    c = run.load_cell(cell)
    assert c["config"]["name"] == c["workload"]["config"]
    from portbench.entries import resolve
    assert isinstance(resolve(c["mix"]["entry"]), type)
    assert c["mix"]["fit_metric"] in {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in {m["name"] for m in c["end_to_end"]}
    assert c["per_layer"], "every cell reports a per-layer metric"
    for m in c["per_layer"]:
        mod = importlib.import_module("portbench.metrics." + m["name"])
        assert callable(mod.read)
    # a limit for every number the cell's fits can give
    assert set(c["limits"]) >= {"holdout_logloss_gap", "holdout_auroc_gap"}
    # 0 is an exact comparison's limit
    assert all(v is None or v >= 0 for v in c["limits"].values())
    assert any(v is not None for v in c["limits"].values())


def test_an_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        run.load_cell("no.such.cell")


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert w["config"] in names and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "portbench", "mixes",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(ROOT, "portbench", "limits",
                                           w["name"] + ".json"))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024
