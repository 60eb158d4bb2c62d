"""Parallel DAG execution engine for Workflow.train() (the port's copy of
``transmogrifai_tpu/executor.py``).

Reference: utils/stages/FitStagesUtil.scala fits the DAG layer by layer,
and Spark's task scheduler runs the independent per-stage jobs of one
layer concurrently across executors. The rework replaces that
with a host thread pool: every stage in a DAG layer has all of its
inputs produced by EARLIER layers (compute_dag's distance-from-raw
layering), so the layer's fits and transforms are mutually independent
and can dispatch concurrently — host-bound fits occupy pool threads
(numpy and the native ingest paths release the GIL), device-bound fits
queue their kernels on the device's stream from whichever thread
submits them (the pool threads share the one stream; every merge below
happens in stage order, so no output depends on the thread schedule).

Determinism contract: results merge into the dataset in the layer's
stage order (compute_dag already sorts each layer by uid), summaries are
collected in the same order, and any stage failure re-raises the
stage-order-FIRST error — fitted models and ``train_summaries`` are
bitwise/JSON-identical to the serial path. ``TM_WORKFLOW_EXECUTOR=serial``
restores the seed one-stage-at-a-time loop.

Beyond concurrency the parallel path does two things the serial loop
never did:

* **Column lifetime pruning** — every column's last consuming layer is
  known up front, so after each layer the dataset drops columns nothing
  downstream reads, and a stage whose OUTPUT has no downstream consumer
  (typically the final model stage: train() discards the scored
  dataset) skips its transform entirely instead of materializing a
  full-train column that is immediately garbage.
* **Fused device transform blocks** — adjacent device-capable column
  transforms in one layer (stages exposing ``make_device_fn`` with
  ``device_fn_exact`` parity, e.g. the Real/Binary impute vectorizers)
  run as ONE plain composition of their torch device functions on the
  train's device instead of one host ``_vectorize`` pass per column
  (the JAX package jits the composition; the port runs it eagerly, no
  ``torch.compile``). Every fusable function is selection-only, so the
  block's f32 outputs equal the host path's bitwise.
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .dataset import Dataset
from .profiling import nan_checks
from .resilience.faults import fault_point
from .resilience.policy import NO_RETRY, RetryPolicy
from .stages.base import Estimator, PipelineStage, Transformer
from .telemetry import recorder as _flight
from .telemetry import spans as _spans

#: executor modes accepted by TM_WORKFLOW_EXECUTOR / Workflow.train
EXECUTOR_MODES = ("parallel", "serial")

#: the class marker a stage declares when its transform has a side
#: effect on the stage itself (VectorsCombiner's manifest,
#: DropIndicesByTransformer's resolved indices). lint/ast_checks flags
#: undeclared caching transforms as TM-LINT-202 against this SAME
#: attribute name, so the linter and the skip below cannot drift.
TRANSFORM_STATE_ATTR = "transform_caches_state"


def transform_skip_safe(model) -> bool:
    """True when lifetime pruning may skip `model.transform` for an
    output no later stage consumes — i.e. the stage declares no
    transform-time state caching."""
    return not getattr(model, TRANSFORM_STATE_ATTR, False)


def resolve_executor(explicit: Optional[str] = None) -> str:
    mode = explicit or os.environ.get("TM_WORKFLOW_EXECUTOR") or "parallel"
    if mode not in EXECUTOR_MODES:
        raise ValueError(f"unknown workflow executor {mode!r}; "
                         f"one of {EXECUTOR_MODES}")
    return mode


def resolve_workers(explicit: Optional[int] = None) -> int:
    if explicit is not None:
        return max(1, int(explicit))
    from .resilience.config import parse_env_fields
    fields = parse_env_fields(
        "TM_WORKFLOW_WORKERS",
        {"TM_WORKFLOW_WORKERS": ("workers", int)},
        what="workflow worker-count env var")
    if "workers" in fields:
        return max(1, fields["workers"])
    return max(2, min(8, os.cpu_count() or 1))


def column_last_use(layers: Sequence[Sequence[PipelineStage]]
                    ) -> Dict[str, int]:
    """column name -> index of the LAST layer that consumes it.

    A column absent from the map has no consumer at all; a column whose
    last use is layer k is dead once layer k has merged. This is the
    whole lifetime model: stages only read their declared inputs and
    append one output, so liveness is static."""
    last: Dict[str, int] = {}
    for li, layer in enumerate(layers):
        for st in layer:
            for n in st.input_names:
                last[n] = li
    return last


# ---------------------------------------------------------------------------
# Fused per-layer device transform blocks
# ---------------------------------------------------------------------------

def _fusable(model: PipelineStage, ds: Dataset) -> bool:
    """True when `model`'s transform may join the layer's fused device
    block: bitwise-exact device fn (device_fn_exact + a cacheable
    signature) over a single 1-D float64 numeric input column."""
    if not isinstance(model, Transformer):
        return False
    if not getattr(model, "device_fn_exact", False):
        return False
    if model.device_fn_signature() is None or len(model.input_names) != 1:
        return False
    col = ds.column(model.input_names[0])
    if not (isinstance(col, np.ndarray) and col.ndim == 1
            and col.dtype == np.float64):
        return False
    return True


def _fused_transform(models: Sequence[Transformer], ds: Dataset,
                     device: torch.device) -> Dict[str, np.ndarray]:
    """The whole group's device functions composed and run once on
    ``device`` -> {output name: f32 array}."""
    fns = [m.make_device_fn() for m in models]
    cols = [torch.from_numpy(np.ascontiguousarray(
        ds.column(m.input_names[0]), np.float32)).to(device)
        for m in models]
    with torch.inference_mode():
        outs = [f(c) for f, c in zip(fns, cols)]
        return {m.output.name: o.cpu().numpy()
                for m, o in zip(models, outs)}


# ---------------------------------------------------------------------------
# Layer execution
# ---------------------------------------------------------------------------

def _check_inputs(st: PipelineStage, ds: Dataset) -> None:
    missing = [n for n in st.input_names if n not in ds]
    if missing:
        raise ValueError(
            f"stage {st.uid} inputs missing from dataset: {missing}"
            f" (dropped by a filter?)")


def _extract_output(model: Transformer, out_ds: Dataset):
    name = model.output.name
    return out_ds.column(name), out_ds.ftype(name), out_ds.manifest(name)


class _Degraded:
    """In-band marker a layer job returns instead of a result tuple
    when a failure_policy="degrade" stage exhausted its retries."""

    __slots__ = ("stage", "error")

    def __init__(self, stage: PipelineStage, error: BaseException):
        self.stage = stage
        self.error = error

    def record(self, layer: int) -> Dict[str, Any]:
        err = self.error
        return {"uid": self.stage.uid,
                "operation": type(self.stage).__name__,
                "output": self.stage.output.name,
                "layer": int(layer),
                "attempts": int(getattr(err, "attempts", 1)),
                "error": f"{type(err).__name__}: {err}"}


def _fit_stage(st: PipelineStage, snapshot: Dataset, li: int,
               policy: RetryPolicy, stats, checkpoint):
    """One stage fit under the retry policy + injection point. Returns
    the fitted model, OR a _Degraded marker when the stage's declared
    failure_policy permits completing the train without it.

    Note on the watchdog: a timed-out attempt is ABANDONED on a daemon
    thread while the retry re-runs fit on the same stage instance.
    That is safe under the stage framework's purity contract
    (stages.base: fit consumes a Dataset and returns a NEW fitted
    transformer, never mutating the estimator) — a fit that caches on
    self violates that contract with or without retries."""
    # stages that do their own intra-fit checkpointing (ModelSelector
    # family progress, streaming refits) get scratch under the train
    # checkpoint — killed mid-STAGE resumes inside the stage too. The
    # hook is scoped to THIS fit: TrainCheckpoint.finish() deletes the
    # scratch, so a pointer left behind would crash the next retrain.
    hook = checkpoint is not None and hasattr(type(st),
                                              "fit_checkpoint_dir")
    if hook:
        st.fit_checkpoint_dir = checkpoint.stage_dir(st.uid)

    def attempt():
        fault_point("executor.stage_fit", stage=st.uid, layer=li)
        return st.fit(snapshot) if isinstance(st, Estimator) else st

    def on_retry(k, e):
        if stats is not None:
            stats.note_retry(st.uid, k, e)

    try:
        return policy.run(attempt, what=f"stage {st.uid} fit",
                          on_retry=on_retry)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:
        if getattr(st, "failure_policy", "fail") == "degrade":
            return _Degraded(st, e)
        raise
    finally:
        if hook:
            st.fit_checkpoint_dir = None


def _apply_degradation(layers: List[List[PipelineStage]], li: int,
                       degraded: List[_Degraded], stats,
                       result_names: Sequence[str]
                       ) -> List[Dict[str, Any]]:
    """Drop degraded stages' outputs from the remaining plan.

    prune_layers cascades exactly like RawFeatureFilter removal:
    variadic consumers shrink to their surviving inputs, fixed-arity
    consumers of a dropped output are removed and their own outputs
    cascade. Degrading is refused (the ORIGINAL error re-raises) when
    the cascade would swallow a result feature — dropping what the
    caller asked for is not graceful."""
    from .workflow import prune_layers

    dropped = {d.stage.output.name for d in degraded}
    cascade = set(dropped)
    tail = prune_layers([list(l) for l in layers[li + 1:]], cascade)
    lost = sorted(n for n in result_names if n in cascade)
    if lost:
        first = degraded[0]
        raise RuntimeError(
            f"stage {first.stage.uid} failed and its failure_policy is "
            f"'degrade', but skipping it would drop result feature(s) "
            f"{lost} — refusing to degrade what the workflow promises "
            f"to return") from first.error
    downstream = sorted(cascade - dropped)
    recs = []
    for d in degraded:
        rec = d.record(li)
        rec["droppedDownstream"] = downstream
        if stats is not None:
            stats.note_degraded(rec)
        _flight.record("executor", "stage.degraded", severity="warning",
                       stage=rec["uid"], layer=li, error=rec["error"],
                       dropped_downstream=downstream)
        recs.append(rec)
    layers[li + 1:] = tail
    # the ENRICHED records (droppedDownstream included) are what the
    # checkpoint must persist: a resumed train replays these verbatim,
    # so bare re-built records would make resumed train_summaries
    # differ from an uninterrupted degraded train
    return recs


def execute(ds: Dataset, layers: Sequence[Sequence[PipelineStage]],
            mode: str = "parallel", workers: int = 2, stats=None,
            policy: Optional[RetryPolicy] = None, checkpoint=None,
            result_names: Sequence[str] = (), device=None
            ) -> Tuple[List[Transformer], List[Tuple[str, Any]]]:
    """Fit the layered DAG over `ds`.

    Returns (fitted stages in serial order, [(output name, summary)]
    in the same order). `stats` is a profiling.TrainStats (optional).

    Resilience hooks (all default-off, zero overhead when unused):
    `policy` retries each stage fit (resilience.policy.RetryPolicy);
    `checkpoint` (resilience.checkpoint.TrainCheckpoint) persists each
    completed layer's fitted state and restores completed layers on
    resume — restored layers re-run only their deterministic
    transforms, never their fits; `result_names` lets graceful
    degradation refuse to drop a promised result feature. `device`
    (None: CUDA, raising without a card) is where the parallel path's
    fused transform blocks run.
    """
    policy = policy or NO_RETRY
    device = resolve_device(device)
    # one sampled trace per train (TM_TRACE_SAMPLE, same tracer as the
    # serving plane): per-stage/per-layer spans make the train's
    # critical path inspectable with the same Perfetto tooling as a
    # request's fan-out. Unsampled trains pay one branch per stage.
    trace = (_spans.TRACER.sample_trace("train")
             if _spans.TRACER.enabled else None)
    if stats is not None and trace is not None:
        stats.trace_id = trace
    sweep_before = None
    skew = 0.0
    if trace is not None:
        # per-chip sweep attribution rides the train span: snapshot the
        # process SweepStats around the whole train so the span carries
        # exactly THIS train's per-device dispatch/item counts (the
        # same delta convention as stageTimings["foldedPrograms"])
        from .profiling import SWEEP_STATS
        sweep_before = SWEEP_STATS.snapshot()
        # stage timings below are time.perf_counter(); the tracer's
        # contract is time.monotonic() (what every serving span uses).
        # On Linux they share an epoch, but not on every platform —
        # record with a once-per-train skew so a combined Perfetto
        # export keeps train and serving spans on one timeline.
        skew = time.monotonic() - time.perf_counter()
    t_train = time.perf_counter()
    with _spans.bound(trace):
        if mode == "serial":
            out = _execute_serial(ds, layers, stats, policy, checkpoint,
                                  result_names, trace, skew, device=device)
        else:
            out = _execute_parallel(ds, layers, workers, stats, policy,
                                    checkpoint, result_names, trace, skew,
                                    device=device)
    if trace is not None:
        from .profiling import SWEEP_STATS, SweepStats
        sweep = SweepStats.delta(sweep_before, SWEEP_STATS.snapshot())
        extra = ({"sweep_devices": sweep["devices"],
                  "sweep_dispatches": sweep["dispatches"]}
                 if sweep.get("devices") else {})
        _spans.TRACER.record(trace, "train", t_train + skew,
                             time.perf_counter() + skew, cat="train",
                             mode=mode, stages=len(out[0]), **extra)
    return out


def _execute_serial(ds, layers, stats, policy=NO_RETRY, checkpoint=None,
                    result_names=(), trace=None, skew=0.0, *,
                    device: torch.device):
    """The seed training loop: one stage at a time, every transform
    materialized, nothing pruned (TM_WORKFLOW_EXECUTOR=serial keeps
    this path available as the behavioral baseline). Retry, degrade,
    and checkpoint semantics match the parallel path."""
    layers = [list(l) for l in layers]
    fitted: List[Transformer] = []
    summaries: List[Tuple[str, Any]] = []
    li = 0
    while li < len(layers):
        layer = layers[li]
        with _spans.TRACER.region("workflow.layer", ring=False):
            wall0 = time.perf_counter()
            busy = 0.0
            critical = 0.0
            restored, premodels, skip_uids = _layer_restore(checkpoint, li,
                                                            layer, device)
            layer_models: List[Transformer] = []
            degraded: List[_Degraded] = []
            for st in layer:
                if _skipped(st, skip_uids):
                    continue
                _check_inputs(st, ds)
                with _spans.TRACER.region("workflow.stage", ring=False):
                    t0 = time.perf_counter()
                    pre = _premodel(premodels, st)
                    model = pre if pre is not None else _fit_stage(
                        st, ds, li, policy, stats, checkpoint)
                    if isinstance(model, _Degraded):
                        degraded.append(model)
                        continue
                    t1 = time.perf_counter()
                    ds = model.transform(ds)
                    t2 = time.perf_counter()
                busy += t2 - t0
                critical = max(critical, t2 - t0)
                if trace is not None:
                    _spans.TRACER.record(trace, f"stage:{model.uid}",
                                         t0 + skew, t2 + skew,
                                         cat="train", layer=li,
                                         fit_s=t1 - t0, transform_s=t2 - t1)
                fitted.append(model)
                layer_models.append(model)
                if stats is not None:
                    stats.note_stage(li, model, ds.n_rows, t1 - t0, t2 - t1,
                                     "host")
                    stats.note_columns(materialized=1)
                summary = getattr(model, "summary", None)
                if summary:
                    summaries.append((model.output.name, summary))
            _finish_layer(layers, li, restored, degraded, stats, checkpoint,
                          result_names, layer_models, summaries)
        if trace is not None:
            _spans.TRACER.record(trace, f"layer:{li}", wall0 + skew,
                                 time.perf_counter() + skew,
                                 cat="train", stages=len(layer))
        if stats is not None:
            stats.note_layer(li, len(layer),
                             time.perf_counter() - wall0, busy,
                             critical_s=critical)
        li += 1
    return fitted, summaries


def summaries_for(layer_models: Sequence[Transformer],
                  summaries: Sequence[Tuple[str, Any]]
                  ) -> List[Tuple[str, Any]]:
    """The slice of collected summaries belonging to one layer's models
    (persisted in that layer's checkpoint file for debuggability)."""
    names = {m.output.name for m in layer_models}
    return [(n, s) for n, s in summaries if n in names]


def _layer_restore(checkpoint, li: int, layer, device
                   ) -> Tuple[Optional[tuple], Dict[str, Transformer],
                              set]:
    """(restored triple, {uid: restored model}, stage uids degraded in
    the checkpointed run) — all empty when the layer fits live. Restored
    models move to the train's ``device``."""
    restored = (checkpoint.restore_layer(li, layer)
                if checkpoint is not None else None)
    premodels: Dict[str, Transformer] = {}
    skip_uids: set = set()
    if restored is not None:
        models, _, degraded_recs = restored
        premodels = {m.uid: m.to(device) for m in models}
        skip_uids = {r["uid"] for r in degraded_recs}
    return restored, premodels, skip_uids


def _skipped(st: PipelineStage, skip_uids: set) -> bool:
    return st.uid in skip_uids or (st.uid + "_model") in skip_uids


def _premodel(premodels: Dict[str, Transformer], st: PipelineStage):
    # fitted estimator models carry the estimator uid + "_model"
    return premodels.get(st.uid) or premodels.get(st.uid + "_model")


def _finish_layer(layers, li: int, restored, degraded: List[_Degraded],
                  stats, checkpoint, result_names,
                  layer_models: List[Transformer],
                  summaries: List[Tuple[str, Any]]) -> bool:
    """Post-merge bookkeeping — ONE implementation for both executors
    (the restore-vs-degrade-vs-persist state machine must not drift
    between them): replay a restored layer's recorded degradations
    verbatim, apply fresh ones (prune cascade), persist the completed
    layer. Returns True when the remaining plan changed, so the
    parallel executor knows to recompute column lifetimes."""
    plan_changed = False
    if restored is not None:
        degraded_recs = restored[2]
        if stats is not None:
            for rec in degraded_recs:
                stats.note_degraded(rec)
            stats.note_resume(resumed=1)
        if degraded_recs:
            # replay the recorded cascade over the remaining plan
            from .workflow import prune_layers
            cascade = {r["output"] for r in degraded_recs}
            layers[li + 1:] = prune_layers(
                [list(l) for l in layers[li + 1:]], cascade)
            plan_changed = True
    elif degraded:
        degraded_recs = _apply_degradation(layers, li, degraded, stats,
                                           result_names)
        plan_changed = True
    else:
        degraded_recs = []
    if checkpoint is not None and restored is None \
            and getattr(checkpoint, "save_layers", True):
        checkpoint.save_layer(li, layer_models,
                              summaries_for(layer_models, summaries),
                              degraded_recs)
        if stats is not None:
            stats.note_resume(checkpointed=1)
    return plan_changed


def _gather_in_order(futures):
    """Collect layer futures in stage order; on the first failure (or a
    KeyboardInterrupt while waiting) cancel everything not yet started
    and return that FIRST real error — a cancelled sibling's
    CancelledError never masks the root cause."""
    results, first_err = [], None
    for f in futures:
        if first_err is not None:
            f.cancel()
            continue
        try:
            results.append(f.result())
        except BaseException as e:      # noqa: BLE001 — re-raised by caller
            first_err = e
            for g in futures:
                g.cancel()
    return results, first_err


def _execute_parallel(ds, layers, workers, stats, policy=NO_RETRY,
                      checkpoint=None, result_names=(), trace=None,
                      skew=0.0, *, device: torch.device):
    """Pipelined layer executor.

    Beyond the per-layer thread pool, stages PIPELINE across layers: a
    completed host transform publishes its output column immediately,
    and any not-yet-submitted later-layer stage whose inputs are all
    materialized is handed to the pool right then — layer N+1 work
    (pure transforms, early fits) no longer waits behind an unrelated
    layer-N fit at a barrier. Determinism is untouched because jobs
    only ever read their declared input columns (the stage purity
    contract): results still MERGE into the canonical dataset in layer
    order / stage order, summaries keep serial order, and the first
    (layer, stage-order) error re-raises.

    Cross-layer pipelining switches itself off when a checkpoint is
    active: restore/skip decisions for layer N are only final once
    every earlier layer has finished (a restored layer's premodels, a
    recorded degradation's prune cascade), so checkpointed trains keep
    the barrier schedule — correctness over overlap.

    Degradation stays safe under pipelining without extra machinery: a
    degraded stage's output never materializes, so no consumer of it
    (the only stages the prune cascade removes or shrinks) can ever
    have been submitted early.
    """
    layers = [list(l) for l in layers]
    last_use = column_last_use(layers)
    fitted: List[Transformer] = []
    summaries: List[Tuple[str, Any]] = []
    pool = ThreadPoolExecutor(max_workers=workers,
                              thread_name_prefix="tm-workflow")
    ahead = checkpoint is None

    state_lock = threading.Lock()
    overlay: Dict[str, Tuple] = {}      # published, not yet merged
    futures: Dict[str, Any] = {}        # stage uid -> Future
    submitted: set = set()
    ds_holder = [ds]
    li_holder = [0]

    def _available(name: str) -> bool:
        return name in ds_holder[0] or name in overlay

    def _snapshot_for(st: PipelineStage):
        """Minimal per-job dataset: exactly the stage's input columns
        (+ their types/manifests) from the canonical dataset or the
        overlay. Stages read only declared inputs, so this is
        observationally identical to the full layer snapshot."""
        cur = ds_holder[0]
        cols: Dict[str, np.ndarray] = {}
        schema: Dict[str, Any] = {}
        mans: Dict[str, Any] = {}
        for n in st.input_names:
            if n in cur:
                cols[n] = cur.column(n)
                schema[n] = cur.ftype(n)
                man = cur.manifest(n)
            else:
                arr, otype, man = overlay[n]
                cols[n] = arr
                schema[n] = otype
            if man is not None:
                mans[n] = man
        return Dataset(cols, schema, mans)

    def _submit_ready_locked():
        """Launch every not-yet-submitted later-layer stage whose
        inputs are all materialized (callers hold state_lock)."""
        if not ahead:
            return
        for lj in range(li_holder[0] + 1, len(layers)):
            for st in layers[lj]:
                if st.uid in submitted:
                    continue
                if all(_available(n) for n in st.input_names):
                    snapshot = _snapshot_for(st)
                    submitted.add(st.uid)
                    futures[st.uid] = pool.submit(
                        _job, st, snapshot, lj, {})

    def _publish(model, kind, out):
        """Make a finished host transform's column visible to waiting
        later-layer stages and schedule whatever just became ready."""
        if not ahead or kind != "host" or out is None:
            return
        with state_lock:
            overlay[model.output.name] = out
            _submit_ready_locked()

    def _job(st, snapshot, lj, premodels):
        # a debug_nans run checks its workers; the stage's fits join the
        # train's trace from the worker thread
        with nan_checks(), _spans.bound(trace), \
                _spans.TRACER.region("workflow.stage", ring=False):
            return _job_body(st, snapshot, lj, premodels)

    def _job_body(st, snapshot, lj, premodels):
        fault_point("executor.pool_worker", stage=st.uid)
        # jobs also report their absolute [start, end) so the layer
        # aggregation can clip pipelined (early-submitted) work to the
        # layer's own wall window — see the busy/critical merge
        t0 = time.perf_counter()
        pre = _premodel(premodels, st)
        model = pre if pre is not None else _fit_stage(
            st, snapshot, lj, policy, stats, checkpoint)
        if isinstance(model, _Degraded):
            return model
        t1 = time.perf_counter()
        out_name = model.output.name
        if out_name not in last_use and transform_skip_safe(model):
            # no downstream consumer: train() discards the final
            # dataset, so materializing this column is pure waste
            # (the final model stage's full-train re-score)
            return model, "skipped", None, t1 - t0, 0.0, t0, t1
        if _fusable(model, snapshot):
            return model, "fused", None, t1 - t0, 0.0, t0, t1
        out = _extract_output(model, model.transform(snapshot))
        t2 = time.perf_counter()
        res = (model, "host", out, t1 - t0, t2 - t1, t0, t2)
        _publish(model, "host", out)
        return res

    try:
        li = 0
        while li < len(layers):
            layer = layers[li]
            with _spans.TRACER.region("workflow.layer", ring=False):
                wall0 = time.perf_counter()
                restored, premodels, skip_uids = _layer_restore(checkpoint,
                                                                li, layer,
                                                                device)
                # input checks run up front in stage order so a
                # filter-dropped column raises the SAME first error the
                # serial loop raises (all earlier layers have merged by
                # now, so the canonical dataset is exactly what the serial
                # loop would hold)
                live_layer = [st for st in layer
                              if not _skipped(st, skip_uids)]
                ds = ds_holder[0]
                for st in live_layer:
                    _check_inputs(st, ds)
                snapshot = ds

                with state_lock:
                    layer_futures = []
                    for st in live_layer:
                        if st.uid not in submitted:
                            submitted.add(st.uid)
                            futures[st.uid] = pool.submit(
                                _job, st, snapshot, li, premodels)
                        layer_futures.append(futures[st.uid])
                # stage-order gather: the first in-order failure re-raises,
                # matching the serial loop's error surface; siblings are
                # cancelled rather than awaited
                results, first_err = _gather_in_order(layer_futures)
                if first_err is not None:
                    raise first_err

                degraded = [r for r in results if isinstance(r, _Degraded)]
                results = [r for r in results if not isinstance(r, _Degraded)]

                fuse_group = [model for model, kind, *_ in results
                              if kind == "fused"]
                fused_out: Dict[str, np.ndarray] = {}
                fuse_s = 0.0
                if fuse_group:
                    t0 = time.perf_counter()
                    fused_out = _fused_transform(fuse_group, snapshot,
                                                 device)
                    fuse_s = time.perf_counter() - t0

                # busy accumulates per-stage (fused stages carry their share
                # of fuse_s as tr_s, so fuse_s is counted exactly once);
                # critical is the layer's longest single-stage chain — the
                # executor's per-layer Amdahl floor in stageTimings. Both
                # clip to the layer's OWN wall window: a pipelined stage
                # that ran during an earlier layer's window already
                # overlapped — counting its full duration here would report
                # a perfectly-overlapped layer as ~100% serial (and inflate
                # pool occupancy past 1). note_stage keeps the stage's full
                # fit/transform cost either way.
                busy = 0.0
                critical = 0.0
                materialized = 0
                layer_models: List[Transformer] = []
                for model, kind, out, fit_s, tr_s, jt0, jt1 in results:
                    name = model.output.name
                    in_window = max(0.0, jt1 - max(jt0, wall0))
                    if kind == "fused":
                        tr_s = fuse_s / len(fuse_group)
                        out = (fused_out[name], model.output.wtype,
                               model.manifest())
                        # the fused transform itself ran at the merge,
                        # always inside this window
                        window_cost = min(fit_s, in_window) + tr_s
                    else:
                        window_cost = min(fit_s + tr_s, in_window)
                    if out is not None:
                        arr, otype, man = out
                        ds = ds.with_column(name, arr, otype, manifest=man)
                        materialized += 1
                    busy += window_cost
                    critical = max(critical, window_cost)
                    if trace is not None:
                        _spans.TRACER.record(trace, f"stage:{model.uid}",
                                             jt0 + skew, jt1 + skew,
                                             cat="train", layer=li,
                                             kind=kind, fit_s=fit_s,
                                             transform_s=tr_s)
                    fitted.append(model)
                    layer_models.append(model)
                    if stats is not None:
                        stats.note_stage(li, model, snapshot.n_rows, fit_s,
                                         tr_s, kind)
                    summary = getattr(model, "summary", None)
                    if summary:
                        summaries.append((name, summary))

                # state_lock: _finish_layer's degradation prune mutates
                # layers[li+1:] in place, and a still-running pipelined job
                # finishing RIGHT NOW would _publish -> _submit_ready_locked
                # and iterate/index that same list — the shrink mid-scan
                # would raise IndexError instead of degrading gracefully
                with state_lock:
                    plan_changed = _finish_layer(layers, li, restored,
                                                 degraded, stats, checkpoint,
                                                 result_names, layer_models,
                                                 summaries)
                if plan_changed:
                    # degradation changed the remaining plan: lifetimes too
                    last_use = column_last_use(layers)

                # lifetime pruning: columns whose last consumer was this (or
                # an earlier) layer are dead for the rest of the train
                dead = [n for n in ds.column_names
                        if last_use.get(n, -1) <= li]
                if dead:
                    ds = ds.drop(dead)
                with state_lock:
                    ds_holder[0] = ds
                    li_holder[0] = li + 1
                    for m in layer_models:
                        overlay.pop(m.output.name, None)
                    # drop the merged layer's futures: each completed Future
                    # pins its result tuple (output column included), so
                    # keeping them would hold every produced column until
                    # train end — the lifetime pruning above exists to bound
                    # exactly that
                    for st in layer:
                        futures.pop(st.uid, None)
                    # merged columns may complete a later stage's input set
                    # even when nothing was published this instant (fused /
                    # restored outputs only land at the merge)
                    _submit_ready_locked()
            if trace is not None:
                _spans.TRACER.record(trace, f"layer:{li}", wall0 + skew,
                                     time.perf_counter() + skew,
                                     cat="train", stages=len(layer))
            if stats is not None:
                stats.note_columns(materialized=materialized,
                                   pruned=len(dead))
                stats.note_layer(li, len(layer),
                                 time.perf_counter() - wall0, busy,
                                 critical_s=critical)
            li += 1
    except BaseException:
        # prompt abort: cancel queued jobs and abandon running fits
        # instead of blocking on stragglers — the first real exception
        # (never a secondary CancelledError) propagates NOW. Abandoned
        # fits on pool threads finish (or their watchdogs abandon them)
        # without anyone joining on the results.
        pool.shutdown(wait=False, cancel_futures=True)
        raise
    else:
        pool.shutdown(wait=True)
    return fitted, summaries
