"""Workflow engine: lazy feature DAG -> staged fit -> scoring model (the
port's copy of ``transmogrifai_tpu/workflow.py``).

Reference: core/src/main/scala/com/salesforce/op/{OpWorkflow.scala,
OpWorkflowCore.scala, OpWorkflowModel.scala}, utils/stages/FitStagesUtil
.scala (DAG layering + layer-by-layer fit), OpWorkflowModelWriter/Reader.

The reference topologically sorts stages by distance from raw features,
fits estimators layer by layer (each becoming a transformer), then scores
by collapsing contiguous row-functions into one pass. Here: the same DAG
layering; `scoring_row_fn` composes the per-stage row functions for
Spark-free local scoring parity (local/OpWorkflowModelLocal.scala).

The port's entry points run on the card unless the caller passes
``device="cpu"``: ``Workflow.train(device=...)`` hands the device to
every estimator that fits on one (the selector, the checker, the Op*
model stages) and to the executor's fused transform blocks;
``WorkflowModel.load(path, device=...)``, :meth:`WorkflowModel.to` and
``compile_scoring(device=...)`` put the fitted stages' tensors there.
:class:`FusedScorer` serves both a fitted :class:`WorkflowModel` (host
stages walk the Dataset, then the maximal device suffix runs on the
card) and a portable artifact's all-device chain
(``portable.PortableModel``). PyTorch runs the suffix eagerly: shape
buckets bound the padded batch shapes the device sees, not a compile
universe.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .dataset import Dataset
from .features import types as ft
from .features.feature import Feature
from .stages.base import (BinarySequenceEstimator, BinarySequenceTransformer,
                          Estimator, PipelineStage, SequenceEstimator,
                          SequenceTransformer, Transformer)
from .stages.generator import FeatureGeneratorStage, raw_dataset_for
from .stages.persistence import stage_from_json, stage_to_json


def _dag_closure(result_features: Sequence[Feature]) -> Dict[str, Feature]:
    """uid -> Feature over the transitive parent closure."""
    features: Dict[str, Feature] = {}

    def walk(f: Feature):
        if f.uid in features:
            return
        features[f.uid] = f
        for p in f.parents:
            walk(p)

    for f in result_features:
        walk(f)
    return features


def _check_dag_integrity(features: Dict[str, Feature]) -> None:
    """Hard-error on duplicate output names / stage uids in the closure.

    Both defects used to silently last-win into the layer merge (one
    stage's column overwriting another's, or one of two same-uid stages
    vanishing from the layered plan). They are unrecoverable wiring
    bugs, so they fail at workflow construction. The detection rule is
    shared with the opcheck linter (lint/graph.duplicate_pairs), which
    reports the same defects as TM-LINT-003/004 on DAGs built elsewhere.
    """
    from .lint.graph import duplicate_pairs
    name_dups, stage_dups = duplicate_pairs(features.values())
    if name_dups:
        name, prev, uid = name_dups[0]
        raise ValueError(
            f"duplicate output feature name {name!r} (feature uids "
            f"{prev} and {uid}): two stages/builders would write "
            f"the same dataset column and the later one would "
            f"silently win [TM-LINT-004] — rename one output")
    if stage_dups:
        stage_uid, prev_f, feat_uid = stage_dups[0]
        raise ValueError(
            f"stage uid {stage_uid!r} produces two distinct "
            f"output features ({prev_f} and {feat_uid}): duplicate stage "
            f"uids (or one stage object wired twice via set_input) "
            f"collapse to a single DAG node and one output is "
            f"silently dropped [TM-LINT-003] — give each stage a "
            f"unique uid")


def compute_dag(result_features: Sequence[Feature]
                ) -> Tuple[List[Feature], List[List[PipelineStage]]]:
    """Closure over the DAG; returns (raw features, stage layers).

    Layer k holds stages whose inputs are all produced at layers < k —
    the reference's FitStagesUtil.computeDAG distance-from-raw layering.
    Raises ValueError on duplicate output names / stage uids (see
    _check_dag_integrity).
    """
    features = _dag_closure(result_features)
    _check_dag_integrity(features)

    raw = [f for f in features.values() if f.is_raw]
    depth: Dict[str, int] = {}

    def feature_depth(f: Feature) -> int:
        if f.uid in depth:
            return depth[f.uid]
        d = 0 if f.is_raw else 1 + max((feature_depth(p) for p in f.parents),
                                       default=0)
        depth[f.uid] = d
        return d

    stage_depth: Dict[str, Tuple[int, PipelineStage]] = {}
    for f in features.values():
        if f.is_raw or f.origin_stage is None:
            continue
        stage_depth[f.origin_stage.uid] = (feature_depth(f), f.origin_stage)

    if not stage_depth:
        return raw, []
    max_d = max(d for d, _ in stage_depth.values())
    layers: List[List[PipelineStage]] = [[] for _ in range(max_d)]
    for d, st in sorted(stage_depth.values(), key=lambda t: (t[0], t[1].uid)):
        layers[d - 1].append(st)
    return raw, layers


def prune_layers(layers: List[List[PipelineStage]], dropped: set
                 ) -> List[List[PipelineStage]]:
    """Cascade raw-feature removal through the stage DAG.

    Mirrors the reference's blocklist handling (OpWorkflow.setBlocklist):
    variadic (sequence) stages shrink to their surviving inputs, keeping
    the same output feature; fixed-arity stages with any dropped input
    are removed and their outputs cascade.
    """
    out: List[List[PipelineStage]] = []
    for layer in layers:
        kept_layer: List[PipelineStage] = []
        for st in layer:
            alive = tuple(i for i in st.inputs if i.name not in dropped)
            if len(alive) == len(st.inputs):
                kept_layer.append(st)
                continue
            variadic = isinstance(st, (SequenceTransformer, SequenceEstimator,
                                       BinarySequenceTransformer,
                                       BinarySequenceEstimator))
            fixed_ok = (not isinstance(st, (BinarySequenceTransformer,
                                            BinarySequenceEstimator))
                        or (st.inputs and st.inputs[0].name not in dropped))
            if variadic and alive and fixed_ok:
                # shrink a COPY: the user's stage objects may be shared by
                # other workflows and must not be contaminated
                st = copy.copy(st)
                st.inputs = alive  # same output feature, fewer inputs
                kept_layer.append(st)
            else:
                dropped.add(st.output.name)
        if kept_layer:
            out.append(kept_layer)
    return out


class WorkflowModel:
    """A fitted workflow: ordered fitted stages + result features, with
    its fitted tensors on ``device`` (where it scores)."""

    def __init__(self, raw_features: Sequence[Feature],
                 stages: Sequence[Transformer],
                 result_features: Sequence[Feature],
                 train_summaries: Optional[Dict[str, Any]] = None,
                 device=None):
        self.raw_features = list(raw_features)
        self.stages = list(stages)
        self.result_features = list(result_features)
        self.train_summaries = train_summaries or {}
        self.device = (torch.device(device) if device is not None
                       else None)

    def to(self, device) -> "WorkflowModel":
        """Move every fitted stage's tensors to ``device`` (None: CUDA,
        raising without a card), in place; returns the model."""
        dev = resolve_device(device)
        for st in self.stages:
            if isinstance(st, Transformer):
                st.to(dev)
        self.device = dev
        return self

    # -- scoring ---------------------------------------------------------
    def _predictor_raw(self) -> List[Feature]:
        return self.raw_features

    def transform(self, data) -> Dataset:
        ds = raw_dataset_for(data, self.raw_features)
        for st in self.stages:
            ds = st.transform(ds)
        return ds

    def _select_scores(self, ds: Dataset) -> Dataset:
        keep = [f.name for f in self.result_features if f.name in ds]
        raw_cols = [f.name for f in self.raw_features if f.name in ds]
        return ds.select(list(dict.fromkeys(raw_cols + keep)))

    def score(self, data, keep_intermediate: bool = False) -> Dataset:
        ds = self.transform(data)
        return ds if keep_intermediate else self._select_scores(ds)

    def _evaluate_ds(self, ds: Dataset, evaluator,
                     label: Optional[str] = None,
                     prediction: Optional[str] = None) -> Dict[str, Any]:
        label = label or next(f.name for f in self.raw_features if f.is_response)
        prediction = prediction or next(
            f.name for f in self.result_features
            if issubclass(f.wtype, ft.Prediction))
        if getattr(evaluator, "device", False) is None:
            # an evaluator without a device of its own computes its
            # metrics where the model lives
            evaluator = copy.copy(evaluator)
            evaluator.device = self.device
        return evaluator.evaluate(ds, label, prediction)

    def evaluate(self, data, evaluator, label: Optional[str] = None,
                 prediction: Optional[str] = None) -> Dict[str, Any]:
        return self._evaluate_ds(self.transform(data), evaluator,
                                 label, prediction)

    def score_and_evaluate(self, data, evaluator, **kw):
        ds = self.transform(data)  # one pass shared by scores + metrics
        return self._select_scores(ds), self._evaluate_ds(ds, evaluator, **kw)

    def compile_scoring(self, buckets=None, device=None,
                        donate: bool = False) -> "FusedScorer":
        """The host prefix plus the maximal suffix of fitted stages
        exposing `make_device_fn` (numeric vectorizers, VectorsCombiner,
        SanityChecker column filter, model predict) as ONE composed
        device function, so the batch crosses host<->device once in each
        direction (reference: OpTransformer's collapse of contiguous
        row-level transformers).

        `buckets=True` (or an explicit ascending int tuple) turns on
        shape bucketing for serving traffic with varying batch sizes
        (see FusedScorer). `device` moves the fitted stages first (None:
        the model's own device). `donate` is the JAX package's keyword
        (donate the padded inputs to the compiled program); the eager
        scorer pads into fresh tensors that no caller holds, which it
        frees as soon as the tail has read them, so it changes nothing
        here and the scores are the same bits either way."""
        return FusedScorer(self, buckets=buckets, device=device)

    def export_portable(self, path: str, buckets=None) -> Dict[str, str]:
        """Write a self-contained serving artifact (MLeap analog):
        manifest.json + params.npz, the JAX package's portable format.
        `buckets` records the serving bucket set in the manifest (True =
        the default set)."""
        from .portable_export import export_portable
        return export_portable(self, path, buckets=buckets)

    # -- local scoring (reference: local/OpWorkflowModelLocal.scala) ------
    def scoring_row_fn(self) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
        """Compose per-stage row functions into Map->Map local scoring."""
        fns = []
        for st in self.stages:
            fn = st.make_row_fn()
            fns.append((fn, fn.output_name))
        gens = [(f.name, f.origin_stage) for f in self.raw_features]
        result_names = [f.name for f in self.result_features]

        def score_row(record: Dict[str, Any]) -> Dict[str, Any]:
            row = dict(record)
            for name, gen in gens:
                if isinstance(gen, FeatureGeneratorStage):
                    row[name] = gen.extract(record)
            for fn, out_name in fns:
                row[out_name] = fn(row)
            return {n: row.get(n) for n in result_names}

        return score_row

    # -- introspection ----------------------------------------------------
    def stage_by_output(self, name: str) -> Optional[Transformer]:
        for st in self.stages:
            if st.output.name == name:
                return st
        return None

    def selected_model(self):
        """The fitted selector's model: a dense SelectedModel or the
        sparse front door's SparseSelectedModel."""
        from .models.selector import SelectedModel
        from .models.sparse import SparseSelectedModel
        for st in self.stages:
            if isinstance(st, (SelectedModel, SparseSelectedModel)):
                return st
        return None

    def model_insights(self, feature: Optional[Feature] = None) -> Dict[str, Any]:
        from .insights import model_insights
        return model_insights(self, feature)

    # -- persistence (reference: OpWorkflowModelWriter/Reader) ------------
    def save(self, path: str, overwrite: bool = True) -> None:
        """Atomic save: workflow.json commits via tmp+fsync+rename and
        the dir is stamped complete (resilience.atomic SENTINEL) last —
        a crash mid-save leaves a dir `load` rejects loudly instead of
        a parseable-but-torn model. The document is the JAX package's
        (its class keys, numpy parameter pytrees), so either package
        loads it."""
        from .resilience import atomic
        if os.path.exists(path) and not overwrite:
            raise FileExistsError(path)
        os.makedirs(path, exist_ok=True)
        atomic.clear_complete(path)     # rewriting: not complete until done
        doc = {
            "version": 1,
            "rawFeatures": [
                {"stage": stage_to_json(f.origin_stage), "uid": f.uid}
                for f in self.raw_features],
            "stages": [stage_to_json(st) for st in self.stages],
            "resultFeatures": [f.name for f in self.result_features],
            "trainSummaries": self.train_summaries,
        }
        atomic.atomic_write_json(os.path.join(path, "workflow.json"),
                                 doc, default=_json_default)
        atomic.mark_complete(path)

    @staticmethod
    def load(path: str, device=None) -> "WorkflowModel":
        """Load a saved workflow (by either package) onto ``device``
        (None: CUDA, raising without a card)."""
        from .resilience import atomic
        dev = resolve_device(device)
        atomic.require_complete(path, "saved WorkflowModel")
        with open(os.path.join(path, "workflow.json")) as f:
            doc = json.load(f)
        raw_features: List[Feature] = []
        for rf in doc["rawFeatures"]:
            gen = stage_from_json(rf["stage"])
            feat = Feature(gen.feature_name, gen.wtype, gen, (),
                           gen.is_response, rf["uid"])
            gen._output = feat
            raw_features.append(feat)
        stages = [stage_from_json(d) for d in doc["stages"]]
        by_name: Dict[str, Feature] = {f.name: f for f in raw_features}
        for st in stages:
            by_name[st.output.name] = st.output
        result_features = [by_name[n] for n in doc["resultFeatures"]]
        return WorkflowModel(raw_features, stages, result_features,
                             doc.get("trainSummaries", {})).to(dev)


def _json_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


#: default serving bucket set: powers of two spanning micro-batch to
#: bulk-chunk sizes (batches above the top bucket split into top-bucket
#: slices)
DEFAULT_SCORE_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192,
                         16384, 32768)


def _normalize_buckets(buckets):
    if buckets is None:
        return None
    if buckets is True:
        return DEFAULT_SCORE_BUCKETS
    out = tuple(sorted({int(b) for b in buckets}))
    if not out or out[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets!r}")
    return out


def _pad_rows(col: np.ndarray, rows: int) -> np.ndarray:
    """Edge-pad axis 0 to `rows` (repeat the last real row: realistic
    values, no NaN/overflow surprises in padded lanes; padded outputs
    are sliced off before anything reads them). An empty column zero-
    pads (no last row to repeat)."""
    n = col.shape[0]
    if n == rows:
        return col
    if n == 0:
        return np.zeros((rows,) + col.shape[1:], col.dtype)
    return np.concatenate([col, np.repeat(col[-1:], rows - n, axis=0)])


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device`` without a stream sync: a CUDA
    copy goes through pinned host memory, so it is queued on the current
    stream and the host goes on (the one sync of a batch is the
    ``.cpu()`` in finalize; PyTorch's pinned allocator keeps the block
    until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def request_columns(data) -> Tuple[int, Dict[str, Any]]:
    """Normalize one request's ``{column: array}`` data (or an object
    whose ``.columns`` is such a dict) -> (rows, columns). Raises on a
    non-dict, an empty request, or ragged columns — failing the ragged
    request at ITS OWN submit, before coalescing could hide it."""
    cols = (data.columns if hasattr(data, "columns")
            and isinstance(getattr(data, "columns"), dict) else data)
    if not isinstance(cols, dict):
        raise TypeError("scoring expects {column: array} request data")
    n = first = None
    for k, v in cols.items():
        m = len(np.asarray(v))
        if n is None:
            n, first = m, k
        elif m != n:
            raise ValueError(
                f"request column {k!r} has {m} rows but {first!r} "
                f"has {n}; all supplied columns must share one length")
    if n is None:
        raise ValueError("request supplied no columns")
    return n, cols


class FusedScorer:
    """Fused batch scoring: host prefix + ONE composed device tail.

    Built by ``WorkflowModel.compile_scoring()`` or
    ``PortableModel.compile_scoring()``. Over a :class:`WorkflowModel`,
    host-only stages (text parsing, string indexing, hashing over object
    columns) run as the stage-walk prefix over the raw Dataset, and the
    maximal device-able suffix runs as one function on ``device``
    (None: the model's own device) whose outputs are the numeric result
    columns. Over a portable artifact's chain every stage is a device
    stage, and requests are ``{column: array}`` dicts. Response-typed
    boundary inputs absent at scoring time are fed zero placeholders
    (device fns ignore them, like the reference's OpTransformer scoring
    label-free rows).

    Serving-grade extras as in the JAX package:

    * **Shape bucketing** (`buckets=True` or an ascending int tuple):
      every batch's row count pads up to the smallest bucket that fits
      (batches above the top bucket split into top-bucket slices).
      Padded rows are sliced off before results surface — the device
      tail is a composition of row-level functions, so padding never
      leaks into real rows.
    * **Observability** (`self.stats`): per-bucket batch/row/padded-row
      counters (profiling.ScoringStats).

    Exposes what the fused serving plane reads (serving/fusion.py):
    ``device_infos`` (input names, device fn, output name per stage),
    ``device_stage_by_output``, ``boundary``, ``_response_boundary``,
    ``result_names`` and ``buckets``."""

    def __init__(self, model, buckets=None, device=None):
        from .profiling import ScoringStats

        if device is not None:
            model = model.to(resolve_device(device))
        self.model = model
        self.device = resolve_device(model.device)
        self.buckets = _normalize_buckets(buckets)
        self.stats = ScoringStats()
        #: a fitted WorkflowModel (raw Dataset in) or a portable chain
        #: ({column: array} requests in)
        self._workflow = isinstance(model, WorkflowModel)
        stages = model.stages
        k = len(stages)
        infos: List[Tuple[List[str], Callable, str]] = []
        while k > 0:
            st = stages[k - 1]
            fn = (st.make_device_fn()
                  if isinstance(st, Transformer) else None)
            if fn is None:
                break
            infos.append((st.input_names, fn, st.output.name))
            k -= 1
        infos.reverse()
        self.host_stages = stages[:k]
        self.device_infos = infos
        self.device_stage_by_output = {
            st.output.name: st for st in stages[k:]}

        produced: set = set()
        boundary: List[str] = []
        for in_names, _, out in infos:
            for n in in_names:
                if n not in produced and n not in boundary:
                    boundary.append(n)
            produced.add(out)
        self.boundary = boundary
        #: boundary columns a device stage reads as hashed bucket ids
        #: (SparseIndices): they stay integer on their way to the card
        self.index_boundary = {
            n for in_names, _, out in infos
            for n, t in zip(in_names,
                            self.device_stage_by_output[out].in_types)
            if n in boundary and issubclass(t, ft.SparseIndices)}
        if self._workflow:
            self.result_names = [f.name for f in model.result_features
                                 if f.name in produced]
            feats: Dict[str, Feature] = {f.name: f
                                         for f in model.raw_features}
            for st in stages:
                feats[st.output.name] = st.output
            self._response_boundary = {
                n for n in boundary
                if n in feats and feats[n].is_response}
        else:
            self.result_names = [n for n in model.result_names
                                 if n in produced]
            self._response_boundary = {
                n for n in boundary if n in model.response_boundary}

        device_outputs = tuple(self.result_names)

        def fused(bvals):
            cols = dict(zip(boundary, bvals))
            for in_names, fn, out in infos:
                cols[out] = fn(*[cols[n] for n in in_names])
            return tuple(cols[n] for n in device_outputs)

        self._fn = fused

    def run_tail(self, dev_vals: Sequence[torch.Tensor]):
        """The device tail over one padded slice's boundary tensors."""
        with torch.inference_mode():
            return self._fn(dev_vals)

    def _host_ds(self, data):
        """The host prefix: a WorkflowModel's raw Dataset through its
        host stages; a portable chain's request columns as given."""
        if not self._workflow:
            return request_columns(data)[1]
        ds = raw_dataset_for(data, self.model.raw_features)
        for st in self.host_stages:
            ds = st.transform(ds)
        return ds

    def _boundary_of(self, src) -> Tuple[int, List[np.ndarray]]:
        """Host-side boundary columns of a host-prefix result (Dataset
        or request columns) in their device dtypes: integer columns and
        hashed-index columns int32 (hashed ids must NOT round-trip
        through f32; int32 is what the card's gathers take), everything
        else f32; absent response columns become zero placeholders; any
        other absent column raises."""
        if isinstance(src, Dataset):
            n, get = src.n_rows, src.column
        else:
            n, src = request_columns(src)
            get = src.__getitem__
        vals = []
        for name in self.boundary:
            if name in src:
                col = np.asarray(get(name))
                if (np.issubdtype(col.dtype, np.integer)
                        or name in self.index_boundary):
                    vals.append(col.astype(np.int32))
                else:
                    vals.append(col.astype(np.float32))
            elif name in self._response_boundary:
                vals.append(np.zeros((n,), np.float32))
            else:
                raise ValueError(
                    f"fused scoring input {name!r} missing from data")
        return n, vals

    def _boundary_host(self, data) -> Tuple[int, List[np.ndarray]]:
        """The whole host side of one batch: host prefix, then the
        boundary columns (what the serving backend's prepare runs)."""
        return self._boundary_of(self._host_ds(data))

    def _bucket_slices(self, n: int):
        """Yield (start, stop, padded_rows) row slices covering [0, n).

        Unbucketed: one exact-shape slice. Bucketed: slices of the top
        bucket, then the remainder padded up to the smallest bucket
        that fits (an EMPTY batch pads to the smallest bucket)."""
        if self.buckets is None:
            yield 0, n, n
            return
        if n == 0:
            yield 0, 0, self.buckets[0]
            return
        top = self.buckets[-1]
        start = 0
        while n - start > top:
            yield start, start + top, top
            start += top
        rem = n - start
        yield start, n, next(b for b in self.buckets if b >= rem)

    def _dispatch(self, n: int, vals: Sequence[np.ndarray]):
        """Launch the device tail for one chunk; returns in-flight parts
        (device work is queued on the current stream, not waited on)."""
        parts = []
        for start, stop, bucket in self._bucket_slices(n):
            dev = [to_device(_pad_rows(v[start:stop], bucket), self.device)
                   for v in vals]
            outs = self.run_tail(dev)
            if bucket not in self.stats.compiles:
                self.stats.note_compile(bucket)    # this shape's first pass
            self.stats.note_batch(bucket, stop - start)
            parts.append((stop - start, outs))
        return parts

    def _finalize(self, parts) -> Dict[str, np.ndarray]:
        """Materialize one chunk's in-flight parts, slicing padding off."""
        pieces: List[List[np.ndarray]] = [[] for _ in self.result_names]
        for m, outs in parts:
            for acc, o in zip(pieces, outs):
                acc.append(o[:m].cpu().numpy())
        return {name: (ps[0] if len(ps) == 1
                       else np.concatenate(ps, axis=0))
                for name, ps in zip(self.result_names, pieces)}

    def _device_arrays(self, src) -> Dict[str, np.ndarray]:
        n, vals = self._boundary_of(src)
        return self._finalize(self._dispatch(n, vals))

    def score_arrays(self, data) -> Dict[str, np.ndarray]:
        """One-call batch scoring -> {result name: (n, k) f32 array}.

        Prediction results come back as (n, k) probability / prediction
        matrices (use `score` for the object-column API parity)."""
        with self.stats.timed():
            return self._device_arrays(self._host_ds(data))

    def score_stream(self, chunks: Iterable[Any], buffer_size: int = 2,
                     host_thread: bool = True, cancel_event=None
                     ) -> Iterable[Dict[str, np.ndarray]]:
        """Double-buffered streaming scoring: yields one
        ``{result name: array}`` dict per input chunk, in order, each
        equal to :meth:`score_arrays` of that chunk.

        The host prefix (parsing, indexing, hashing, boundary assembly)
        for chunk k+1 runs on a background thread
        (io.stream.host_prefetch) while chunk k's device tail runs:
        ``_dispatch`` queues the copies and the tail without waiting on
        the card, ``_finalize`` reads the results back
        (io.stream.double_buffer keeps ``buffer_size`` chunks in
        flight). Producer exceptions re-raise positionally: results for
        every chunk before the failure are yielded first.

        stats.seconds accumulates only time spent INSIDE the pipeline
        (waiting on host production, dispatch, materialization) — the
        consumer's work between yields is excluded.

        `cancel_event` (threading.Event) aborts the stream from outside:
        once set, the producer thread stops pulling chunks and the
        stream raises io.stream.StreamCancelled instead of draining the
        source."""
        import time

        from .io.stream import (StreamCancelled, double_buffer,
                                host_prefetch)

        def produce():
            for chunk in chunks:
                if cancel_event is not None and cancel_event.is_set():
                    raise StreamCancelled("score_stream cancelled")
                yield self._boundary_host(chunk)

        src = (host_prefetch(produce(), buffer_size,
                             cancel_event=cancel_event) if host_thread
               else produce())
        it = double_buffer(src, lambda nv: self._dispatch(*nv),
                           self._finalize, depth=buffer_size)
        while True:
            t0 = time.perf_counter()
            try:
                out = next(it)
            except StopIteration:
                return
            finally:
                self.stats.add_seconds(time.perf_counter() - t0)
            if cancel_event is not None and cancel_event.is_set():
                raise StreamCancelled("score_stream cancelled")
            yield out

    def score(self, data) -> Dataset:
        """API-parity scoring of a WorkflowModel: fused compute, then
        Prediction formatting."""
        from .models.base import prediction_column

        if not self._workflow:
            raise TypeError("FusedScorer.score formats a WorkflowModel's "
                            "results; a portable chain scores through "
                            "score_arrays")
        ds = self._host_ds(data)
        arrays = self._device_arrays(ds)
        for name, arr in arrays.items():
            st = self.device_stage_by_output.get(name)
            if st is not None and issubclass(st.output.wtype, ft.Prediction):
                col = prediction_column(
                    arr, st.params.get("problem", "binary"))
                ds = ds.with_column(name, col, ft.Prediction)
            else:
                ds = ds.with_column(name, arr, st.output.wtype if st else
                                    ft.OPVector)
        keep = [f.name for f in self.model.raw_features if f.name in ds]
        keep += [n for n in (f.name for f in self.model.result_features)
                 if n in ds]
        return ds.select(list(dict.fromkeys(keep)))


class Workflow:
    """Lazy workflow: set result features (+ optional reader), then train.

    Reference: core/OpWorkflow.scala. `train` fits the DAG layer by layer
    (estimators become transformers); an optional RawFeatureFilter runs
    first (filters/ module).
    """

    def __init__(self, result_features: Sequence[Feature],
                 reader=None, raw_feature_filter=None):
        if not result_features:
            raise ValueError("workflow needs at least one result feature")
        self.result_features = list(result_features)
        self.reader = reader
        self.raw_feature_filter = raw_feature_filter
        self.train_summaries: Dict[str, Any] = {}
        # fail on irrecoverable wiring bugs (duplicate output names /
        # stage uids) HERE, not mid-train: the closure walk + integrity
        # check alone — train() computes the full layering later anyway
        _check_dag_integrity(_dag_closure(self.result_features))

    def set_reader(self, reader) -> "Workflow":
        self.reader = reader
        return self

    def with_raw_feature_filter(self, **kwargs) -> "Workflow":
        """Attach a RawFeatureFilter (reference: OpWorkflow
        .withRawFeatureFilter). kwargs pass through to RawFeatureFilter."""
        from .filters import RawFeatureFilter
        self.raw_feature_filter = RawFeatureFilter(**kwargs)
        return self

    def _training_data(self, data):
        # readers are dispatched inside raw_dataset_for
        if data is not None:
            return data
        if self.reader is None:
            raise ValueError("no training data: pass data= or set a reader")
        return self.reader

    def train(self, data=None, executor: Optional[str] = None,
              max_workers: Optional[int] = None,
              lint: Optional[str] = None,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every_layer: bool = True,
              resume: bool = False,
              retry=None, device=None) -> WorkflowModel:
        """Fit the DAG layer by layer (executor.py) on ``device`` (None:
        CUDA, raising without a card; ``"cpu"`` on the host). Every
        estimator that fits on a device (``device`` attribute: the
        selector, the checker, the Op* model stages) gets it, and the
        fused transform blocks run there; the returned model's tensors
        lie there. A train asked for the card never continues on the
        CPU.

        `executor`: "parallel" (default — independent stages of a DAG
        layer fit/transform concurrently with column lifetime pruning
        and fused per-layer device transform blocks) or "serial" (the
        seed one-stage-at-a-time loop). `TM_WORKFLOW_EXECUTOR` sets the
        default; results are identical either way, modulo the
        `stageTimings` timing fields. `max_workers` (or
        `TM_WORKFLOW_WORKERS`) sizes the parallel pool.

        `lint` (or `TM_LINT`): opt-in opcheck pre-flight over the DAG
        before anything fits — "strict" raises lint.LintError on
        error-severity findings, "warn" prints them and continues,
        "off" (default) skips. Whenever the gate runs, the report lands
        in `train_summaries["lintFindings"]` (surfaced by
        model_insights and serving /statusz) so a waived finding stays
        visible downstream.

        Fault tolerance (docs/RESILIENCE.md):

        `checkpoint_dir` (or `TM_TRAIN_CKPT`): durable layer-level
        checkpointing — after each completed DAG layer the fitted
        stage state persists atomically, and a killed train restarted
        with the SAME arguments resumes at the first unfinished layer,
        producing bitwise/JSON-identical fitted models,
        `train_summaries`, and scores. Checkpoints are fingerprinted
        against the plan + data and deleted on success; a drifted
        checkpoint is rejected loudly, never silently reused.
        `checkpoint_every_layer=False` keeps only stage-internal
        checkpoints (selector family progress, streaming refits).
        `resume=True` additionally REQUIRES a resumable checkpoint —
        guarding a deliberate resume against a typo'd dir silently
        training from scratch.

        `retry` (a resilience.RetryPolicy, or `TM_TRAIN_RETRIES` /
        `TM_STAGE_TIMEOUT_S`): bounded retries with deterministic
        backoff + a per-attempt wall-clock watchdog around every stage
        fit. Stages marked `failure_policy="degrade"` are skipped when
        their retries exhaust (prune cascade; recorded in
        `train_summaries["degraded"]`).
        """
        import time

        dev = resolve_device(device)
        from .executor import execute, resolve_executor, resolve_workers
        from .profiling import TrainStats
        from .resilience import checkpoint as ckpt_mod
        from .resilience import faults
        from .resilience.policy import resolve_train_policy

        from .lint import preflight
        lint_report = preflight(self, mode=lint)
        if lint_report is not None:
            self.train_summaries["lintFindings"] = lint_report.as_dict()
        else:
            # a gate-off retrain must not inherit a PREVIOUS gated
            # train's findings — this train was not linted
            self.train_summaries.pop("lintFindings", None)

        policy = resolve_train_policy(retry)
        # a PREVIOUS train's per-run records must not survive into this
        # run's summaries (same hygiene as lintFindings above)
        self.train_summaries.pop("degraded", None)
        self.train_summaries.pop("faultInjection", None)
        self.train_summaries.pop("rawFeatureFilter", None)
        faults_before = faults.stats_dict()
        raw, layers = compute_dag(self.result_features)
        for layer in layers:
            for st in layer:
                if isinstance(st, Estimator) and hasattr(st, "device"):
                    st.device = dev
        data = self._training_data(data)

        # materialize ONCE: readers/iterables must not be consumed twice
        # (the filter and the fit share this Dataset). Reader I/O is the
        # classic transient-failure surface (network FS), so the retry
        # policy wraps it too.
        ds = policy.run(lambda: raw_dataset_for(data, raw),
                        what="training data read")

        if self.raw_feature_filter is not None:
            rff = self.raw_feature_filter
            try:
                kept, filter_summary = policy.run(
                    lambda: rff.filter_features(raw, ds),
                    what="raw feature filter")
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                if getattr(rff, "failure_policy", "fail") != "degrade":
                    raise
                # the filter is advisory (it only ever REMOVES inputs):
                # train on the unfiltered features rather than discard
                # the run, and record the degradation loudly
                self.train_summaries.setdefault("degraded", []).append({
                    "uid": "rawFeatureFilter",
                    "operation": type(rff).__name__,
                    "output": None, "layer": -1,
                    "attempts": int(getattr(e, "attempts", 1)),
                    "error": f"{type(e).__name__}: {e}",
                    "droppedDownstream": []})
                kept, filter_summary = list(raw), None
            if filter_summary is not None:
                self.train_summaries["rawFeatureFilter"] = filter_summary
            dropped = {f.name for f in raw} - {f.name for f in kept}
            if dropped:
                layers = prune_layers(layers, set(dropped))
                missing = [f.name for f in self.result_features
                           if f.name in dropped
                           or (not f.is_raw and not any(
                               st.uid == f.origin_stage.uid
                               for lay in layers for st in lay))]
                if missing:
                    raise ValueError(
                        f"RawFeatureFilter removed features that the result "
                        f"features depend on non-redundantly: {missing}")
            raw = kept
            ds = ds.select([f.name for f in raw])

        ckpt = None
        ckpt_dir = ckpt_mod.resolve_checkpoint_dir(checkpoint_dir)
        if ckpt_dir:
            token = ckpt_mod.train_fingerprint(raw, layers, ds)
            ckpt = ckpt_mod.TrainCheckpoint.open(
                ckpt_dir, token, len(layers), require_resume=resume)
            ckpt.save_layers = bool(checkpoint_every_layer)
        elif resume:
            raise ValueError("resume=True needs checkpoint_dir= (or "
                             "TM_TRAIN_CKPT) pointing at the checkpoint")

        mode = resolve_executor(executor)
        workers = resolve_workers(max_workers) if mode == "parallel" else 1
        stats = TrainStats(mode, workers)
        from .profiling import SWEEP_STATS
        sweep_before = SWEEP_STATS.snapshot()
        t0 = time.perf_counter()
        fitted, summaries = execute(
            ds, layers, mode=mode, workers=workers, stats=stats,
            policy=policy, checkpoint=ckpt,
            result_names=[f.name for f in self.result_features],
            device=dev)
        stats.set_total(time.perf_counter() - t0)
        # THIS train's sweep execute attribution (delta, not
        # process-cumulative)
        sweep_delta = SWEEP_STATS.delta(sweep_before,
                                        SWEEP_STATS.snapshot())
        if sweep_delta["dispatches"]:
            stats.set_folded_programs(sweep_delta)
        for name, summary in summaries:
            self.train_summaries[name] = summary
        if stats.degraded:
            merged = self.train_summaries.get("degraded", [])
            self.train_summaries["degraded"] = merged + list(stats.degraded)
        faults_now = faults.stats_dict()
        fault_delta = {
            kind: {k: v - faults_before[kind].get(k, 0)
                   for k, v in faults_now[kind].items()
                   if v - faults_before[kind].get(k, 0)}
            for kind in ("arrivals", "injected")}
        if fault_delta["injected"]:
            # a fault drill fired inside THIS train: record this run's
            # delta, not the process-cumulative counters (a second
            # train in the same process must not inherit the first
            # drill's numbers)
            self.train_summaries["faultInjection"] = fault_delta
        self.train_summaries["stageTimings"] = stats.as_dict()
        if ckpt is not None:
            ckpt.finish()       # success: the next train starts fresh
        if os.environ.get("TM_WORKFLOW_PROFILE") == "1":
            import sys
            print(stats.format_table(), file=sys.stderr, flush=True)
        return WorkflowModel(raw, fitted, self.result_features,
                             dict(self.train_summaries), device=dev)
