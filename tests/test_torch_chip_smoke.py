"""chip_smoke.py's training phase on the CPU: the tree selector over
the four families at default grids and registered caps, on 3,000 of
its HIGGS-shaped rows. Holds the script's own checks (winner against
the linear yardstick, the scored column, the exact-mode decision tree
bitwise and GBT per grid point, here CPU against CPU) and the launch
count it derives from the code, which the CPU path does not move. And
the GBT check against planted histogram faults (gbt_parity_probe.py's
arms), CPU against CPU: each must part the trees at a split that is no
near tie.
"""
import pytest

import chip_smoke
import gbt_parity_probe
from transmogrifai_tpu_torch import models as TM
from transmogrifai_tpu_torch.models import kernels as tk


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
    assert set(out["family_wall_s"]) == set(chip_smoke.TREE_FAMILIES)
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
