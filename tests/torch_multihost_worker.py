"""One process of ``tests/test_torch_multihost.py``'s two-process case.

Run as ``python tests/torch_multihost_worker.py ADDR PID OUT [oom]``: joins a
two-process ``gloo`` group at ADDR (this process owning two CPU ranks),
checks the process info and the idempotent second join, the default and
hybrid meshes, a cross-process ``grid_map``, then fits the LR + GBT
selector over the hybrid mesh through ``WorkflowRunner`` TRAIN with
``OpParams.distributed`` and writes what it saw to OUT as JSON. With
``oom``, process 1's first LogisticRegression fit raises an
out-of-memory error, which every process must retry alike.
"""
import json
import os
import sys

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

#: the data and candidates the test's one-process fit uses too
ROWS, FEATURES, SEED = 240, 5, 3
CANDIDATES = [["LogisticRegression", {"regParam": [0.01, 0.1],
                                      "elasticNetParam": [0.0, 0.5]}],
              ["GBTClassifier", {"maxDepth": [2.0, 3.0]}]]
GBT_ROUNDS = 4


def data():
    rng = np.random.default_rng(SEED)
    X = rng.normal(size=(ROWS, FEATURES)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + 0.5 * X[:, 2] > 0).astype(np.float32)
    return X, y


def selector(device):
    """(Dataset, selector) over :func:`data`, GBT cut to GBT_ROUNDS."""
    from transmogrifai_tpu_torch import models as TM
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.features import types as ft
    TM.MODEL_FAMILIES["GBTClassifier"].n_rounds_cap = GBT_ROUNDS
    X, y = data()
    ds = Dataset({"y": y.astype(np.float64), "x": X},
                 {"y": ft.RealNN, "x": ft.OPVector})
    lbl = FeatureBuilder.of(ft.RealNN, "y").from_column().as_response()
    vec = FeatureBuilder.OPVector("x").from_column().as_predictor()
    sel = TM.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=3, candidates=CANDIDATES, device=device).set_input(lbl, vec)
    return ds, sel


def grid_metrics(summary):
    return {r["family"]: [float(m) for m in r["gridMetrics"]]
            for r in summary["validationResults"]}


def plant_oom(family) -> list:
    """The family's first fit in this process raises CUDA's
    out-of-memory error (on one rank thread; its peers then stop at
    their next collective). Returns [fits left before it fires]."""
    import threading
    fit, lock, left = family.fit_batch, threading.Lock(), [1]

    def once(*a, **kw):
        with lock:
            fire, left[0] = left[0] > 0, left[0] - 1
        if fire:
            raise torch.cuda.OutOfMemoryError("planted out-of-memory")
        return fit(*a, **kw)

    family.fit_batch = once
    return left


def main(addr: str, pid: int, out: str, oom: bool = False) -> int:
    torch.set_num_threads(1)
    from transmogrifai_tpu_torch import parallel as par
    from transmogrifai_tpu_torch.parallel import mesh as TMESH
    from transmogrifai_tpu_torch.parallel import multihost, spmd
    from transmogrifai_tpu_torch.runner import (OpParams, RunType,
                                                WorkflowRunner)
    from transmogrifai_tpu_torch.workflow import Workflow
    cpu = torch.device("cpu")
    TMESH.visible_devices = lambda: [cpu, cpu]     # this process's ranks
    seen = {"pid": pid}
    info = multihost.initialize_distributed(addr, 2, pid)
    again = multihost.initialize_distributed(addr, 2, pid)
    seen["info"], seen["again"] = info, again
    mesh = multihost.hybrid_mesh()
    seen["mesh"] = {"axes": list(mesh.axis_names), "shape": mesh.shape,
                    "labels": mesh.labels(), "local_rows": mesh.local_rows}
    os.environ["TM_MESH_AXIS"] = "grid,data"
    dm = par.default_mesh()
    seen["default_mesh"] = {"axes": list(dm.axis_names), "shape": dm.shape}
    os.environ["TM_MESH_AXIS"] = "grid"
    gm = par.default_mesh()
    seen["default_grid_mesh"] = {"axes": list(gm.axis_names),
                                 "shape": gm.shape}

    def fn(items, x):                   # a weighted row sum per item
        total, = spmd.row_sum((torch.as_tensor(items)[:, None]
                               * x[None, :]).sum(1))
        return total

    v = torch.arange(1, 8, dtype=torch.float32)
    seen["grid_map"] = par.grid_map(fn, np.arange(5, dtype=np.float32),
                                    (v,), mesh).tolist()
    seen["grid_map_1d"] = par.grid_map(
        lambda items, x: torch.as_tensor(items) * x.sum(),
        np.arange(5, dtype=np.float32), (v,), gm).tolist()
    ds, sel = selector("cpu")
    left = [1]
    if oom and pid == 1:
        from transmogrifai_tpu_torch import models as TM
        left = plant_oom(TM.MODEL_FAMILIES["LogisticRegression"])
    sel.set_mesh(mesh)
    runner = WorkflowRunner(Workflow([sel.output]), train_reader=ds,
                            device="cpu")
    res = runner.run(RunType.TRAIN, OpParams(distributed={
        "coordinatorAddress": addr, "numProcesses": 2, "processId": pid}))
    summ = runner._model.selected_model().summary
    seen["winner"] = res["bestModel"]["family"]
    seen["grid"] = grid_metrics(summ)
    seen["gathers"] = multihost._GATHERS[0]
    seen["oom_fired"] = left[0] < 1
    with open(out, "w") as f:
        json.dump(seen, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), sys.argv[3],
                  sys.argv[4:] == ["oom"]))
