"""Batch runner + app params (the port's copy of
``transmogrifai_tpu/runner.py``).

Reference: core/src/main/scala/com/salesforce/op/{OpWorkflowRunner.scala,
OpParams.scala, OpApp.scala} — the batch entry point with run types
Train / Score / Evaluate / Features / StreamingScore, JSON/YAML app
params (reader paths, model/metrics locations, per-stage param
overrides), and run-result metadata written per run. StreamingScore maps
the reference's Spark-streaming variant onto host-side chunk streaming
through the fused scorer with incremental writes.

The runner is pure host orchestration — it binds readers, invokes
Workflow.train (whose grid fitting runs on the runner's device: None
resolves to CUDA, raising without a card), and writes JSON/CSV
artifacts. Three fields reach the process around a run, as in the JAX
package: ``compilation_cache_location`` is the build directory of the
port's CUDA kernels for the run (``_compile_cache``; the prior choice
returns afterwards, also when a later step fails), ``distributed`` (or
``COORDINATOR_ADDRESS`` in the environment) joins the process group
(``parallel.multihost.initialize_distributed``), and ``debug_nans``
checks every op of the run for NaN outputs (``profiling.debug_nans``).
"""
from __future__ import annotations

import dataclasses
import enum
import json
import os
import time
from typing import Any, Dict, List, Mapping, Optional

from ._device import resolve_device
from .dataset import Dataset
from .features import types as ft
from .workflow import Workflow, WorkflowModel, _json_default


class RunType(enum.Enum):
    TRAIN = "train"
    SCORE = "score"
    EVALUATE = "evaluate"
    FEATURES = "features"
    #: chunked scoring for data larger than memory (reference analog:
    #: OpWorkflowRunner's StreamingScore run type over Spark streaming;
    #: here chunks stream host-side and score through the fused
    #: scorer, writing scores incrementally)
    STREAMING_SCORE = "streaming_score"


@dataclasses.dataclass
class OpParams:
    """App-level parameters (OpParams.scala), loadable from JSON or YAML.

    `stage_params` maps stage operation/class names to param overrides,
    applied before training; `response` overrides the label column used
    by evaluation runs; `custom_params` is a free-form bag.
    """

    model_location: Optional[str] = None
    metrics_location: Optional[str] = None
    score_location: Optional[str] = None
    train_reader_path: Optional[str] = None
    score_reader_path: Optional[str] = None
    response: Optional[str] = None
    #: write a torch.profiler Chrome trace of the run here
    #: (trace.json; Perfetto / chrome://tracing)
    profile_location: Optional[str] = None
    #: check every op of the run for NaN outputs (profiling.debug_nans)
    debug_nans: bool = False
    #: the build directory of the CUDA kernels for this run
    #: (_compile_cache.set_build_dir; restored afterwards)
    compilation_cache_location: Optional[str] = None
    #: the multi-process launch contract: {"coordinatorAddress",
    #: "numProcesses", "processId"} (parallel.multihost)
    distributed: Dict[str, Any] = dataclasses.field(default_factory=dict)
    stage_params: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    custom_params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    _ALIASES = {
        "modelLocation": "model_location",
        "metricsLocation": "metrics_location",
        "scoreLocation": "score_location",
        "trainReaderPath": "train_reader_path",
        "scoreReaderPath": "score_reader_path",
        "profileLocation": "profile_location",
        "debugNans": "debug_nans",
        "compilationCacheLocation": "compilation_cache_location",
        "stageParams": "stage_params",
        "customParams": "custom_params",
    }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "OpParams":
        known = {f.name for f in dataclasses.fields(cls)}
        kw: Dict[str, Any] = {}
        for k, v in d.items():
            key = cls._ALIASES.get(k, k)
            if key not in known:
                raise ValueError(f"unknown OpParams key: {k!r}")
            kw[key] = v
        return cls(**kw)

    @classmethod
    def from_file(cls, path: str) -> "OpParams":
        with open(path) as f:
            text = f.read()
        if path.endswith((".yaml", ".yml")):
            import yaml
            return cls.from_dict(yaml.safe_load(text) or {})
        return cls.from_dict(json.loads(text))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def apply_stage_params(workflow: Workflow, stage_params: Mapping[str, Mapping[str, Any]]) -> None:
    """Override stage params by class name or operation name before fit."""
    if not stage_params:
        return
    from .workflow import compute_dag
    _, layers = compute_dag(workflow.result_features)
    for layer in layers:
        for st in layer:
            for key in (type(st).__name__, st.operation_name):
                if key in stage_params:
                    st.params.update(stage_params[key])


def _cell_to_str(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, (dict, list, tuple, set, frozenset)):
        if isinstance(v, (set, frozenset)):
            v = sorted(v)
        return json.dumps(v, default=_json_default)
    return str(v)


def _prediction_key_columns(ds: Dataset) -> Dict[str, List[str]]:
    pred_cols: Dict[str, List[str]] = {}
    for name in ds.column_names:
        if issubclass(ds.ftype(name), ft.Prediction):
            keys: List[str] = []
            for i in range(ds.n_rows):
                for k in (ds.raw_value(name, i) or {}):
                    if k not in keys:
                        keys.append(k)
            pred_cols[name] = keys
    return pred_cols


def write_scores_csv(ds: Dataset, path: str, append: bool = False,
                     pred_cols: Optional[Dict[str, List[str]]] = None
                     ) -> Dict[str, List[str]]:
    """Write a scored Dataset to CSV; Prediction maps expand to columns.
    `append=True` skips the header (streaming chunk writes); pass the
    first chunk's `pred_cols` back in so column order stays stable."""
    import csv
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if pred_cols is None:
        pred_cols = _prediction_key_columns(ds)
    with open(path, "a" if append else "w", newline="") as f:
        w = csv.writer(f)
        header: List[str] = []
        for name in ds.column_names:
            if name in pred_cols:
                header.extend(f"{name}.{k}" for k in pred_cols[name])
            else:
                header.append(name)
        if not append:
            w.writerow(header)
        for i in range(ds.n_rows):
            row: List[str] = []
            for name in ds.column_names:
                v = ds.raw_value(name, i)
                if name in pred_cols:
                    m = v or {}
                    row.extend(_cell_to_str(m.get(k)) for k in pred_cols[name])
                else:
                    row.append(_cell_to_str(v))
            w.writerow(row)
    return pred_cols


def _iter_reader_chunks(reader, chunk_rows: int):
    """Yield record-dict chunks; CSV readers stream row-by-row so the
    whole file is never resident (other readers chunk their record list).

    Aggregate/conditional readers are rejected: chunking raw events would
    bypass (and split) their per-key aggregation — use SCORE for those.
    """
    from .readers.core import (AggregateDataReader, CSVProductReader,
                               _parse_cell)
    if isinstance(reader, AggregateDataReader):
        raise ValueError(
            "STREAMING_SCORE cannot chunk aggregate/conditional readers "
            "(per-key aggregation would split across chunks); use SCORE")
    if type(reader) is CSVProductReader or (
            isinstance(reader, CSVProductReader)
            and type(reader).read is CSVProductReader.read):
        import csv as csvmod
        names = list(reader.schema)
        buf: List[Dict[str, Any]] = []
        with open(reader.path, newline="") as fh:
            rows = csvmod.reader(fh, delimiter=reader.delimiter)
            for i, row in enumerate(rows):
                if i == 0 and reader.header:
                    names = [n.strip() for n in row]
                    unknown = [n for n in names if n not in reader.schema]
                    if unknown:          # same error the batch path raises
                        raise ValueError(
                            f"CSV columns not in schema: {unknown}")
                    continue
                rec: Dict[str, Any] = {}
                for nm, c in zip(names, row):
                    try:
                        rec[nm] = _parse_cell(c, reader.schema[nm])
                    except ValueError as e:
                        raise ValueError(f"{reader.path} row {i} column "
                                         f"{nm!r}: {e}") from e
                buf.append(rec)
                if len(buf) >= chunk_rows:
                    yield buf
                    buf = []
        if buf:
            yield buf
        return
    recs = reader.read()
    for i in range(0, len(recs), chunk_rows):
        yield recs[i:i + chunk_rows]


class WorkflowRunner:
    """Dispatches one run (OpWorkflowRunner.run): binds readers, executes
    the run type, writes artifacts, returns a result summary dict."""

    def __init__(self, workflow: Workflow,
                 train_reader=None, score_reader=None, evaluator=None,
                 device=None):
        self.workflow = workflow
        self.train_reader = train_reader
        self.score_reader = score_reader
        self.evaluator = evaluator
        #: where runs train and score (None: CUDA, resolved per run and
        #: raising without a card)
        self.device = device

    def run(self, run_type: RunType, params: Optional[OpParams] = None
            ) -> Dict[str, Any]:
        params = params or OpParams()
        t0 = time.time()
        if isinstance(run_type, str):
            run_type = RunType(run_type.lower())
        handler = {
            RunType.TRAIN: self._run_train,
            RunType.SCORE: self._run_score,
            RunType.EVALUATE: self._run_evaluate,
            RunType.FEATURES: self._run_features,
            RunType.STREAMING_SCORE: self._run_streaming_score,
        }[run_type]
        from . import _compile_cache
        from .profiling import debug_nans, trace
        chose_cache, prev_cache = False, None
        try:
            # inside the try so a failure anywhere below (the
            # distributed init included) still restores the build dir
            if params.compilation_cache_location:
                os.makedirs(params.compilation_cache_location, exist_ok=True)
                prev_cache = _compile_cache.set_build_dir(
                    params.compilation_cache_location)
                chose_cache = True
            if params.distributed or os.environ.get("COORDINATOR_ADDRESS"):
                # explicit params OR the documented env launch contract
                from .parallel import multihost
                multihost.initialize_distributed(
                    params.distributed.get("coordinatorAddress"),
                    params.distributed.get("numProcesses"),
                    params.distributed.get("processId"))
            self._device = resolve_device(self.device)
            with trace(params.profile_location), \
                    debug_nans(params.debug_nans):
                result = handler(params)
        finally:
            if chose_cache:
                _compile_cache.set_build_dir(prev_cache)
        result.update({"runType": run_type.value,
                       "wallSeconds": round(time.time() - t0, 3)})
        if params.profile_location:
            result["profileLocation"] = params.profile_location
        if params.metrics_location:
            os.makedirs(params.metrics_location, exist_ok=True)
            out = os.path.join(params.metrics_location,
                               f"{run_type.value}_result.json")
            with open(out, "w") as f:
                json.dump(result, f, indent=1, default=_json_default)
        return result

    # -- run types --------------------------------------------------------
    def _run_train(self, params: OpParams) -> Dict[str, Any]:
        apply_stage_params(self.workflow, params.stage_params)
        if self.train_reader is not None:
            self.workflow.set_reader(self.train_reader)
        model = self.workflow.train(device=self._device)
        result: Dict[str, Any] = {}
        if params.model_location:
            model.save(params.model_location)
            result["modelLocation"] = params.model_location
        insights = model.model_insights()
        if params.metrics_location:
            os.makedirs(params.metrics_location, exist_ok=True)
            with open(os.path.join(params.metrics_location,
                                   "model_insights.json"), "w") as f:
                json.dump(insights, f, indent=1, default=_json_default)
        if self.evaluator is not None and self.train_reader is not None:
            result["trainMetrics"] = model.evaluate(
                self.train_reader, self.evaluator, label=params.response)
        sel = model.selected_model()
        if sel is not None:
            summ = sel.summary or {}
            best = summ.get("bestModel", {})
            result["bestModel"] = {
                "family": sel.params.get("family") or best.get("family"),
                "hyper": best.get("hyper")}
            if "fieldContributions" in summ:  # sparse selector insight
                result["fieldContributions"] = summ["fieldContributions"]
        self._model = model
        self._model_location = params.model_location
        return result

    def _load_model(self, params: OpParams) -> WorkflowModel:
        model = getattr(self, "_model", None)
        # the cached model is only valid when it IS the one the params
        # point at (or the params don't point anywhere)
        if model is not None and (
                not params.model_location
                or params.model_location == getattr(self, "_model_location",
                                                    None)):
            return model
        if not params.model_location:
            raise ValueError("model_location required (or run TRAIN first)")
        return WorkflowModel.load(params.model_location,
                                  device=self._device)

    def _score_reader(self):
        if self.score_reader is None:
            raise ValueError("runner needs a score_reader for this run type")
        return self.score_reader

    @staticmethod
    def _has_labels(model: WorkflowModel, ds: Dataset,
                    label: Optional[str]) -> bool:
        import numpy as np
        name = label or next((f.name for f in model.raw_features
                              if f.is_response), None)
        if name is None or name not in ds:
            return False
        col = ds.column(name).astype(np.float64)
        return bool(np.isfinite(col).any())

    def _run_score(self, params: OpParams) -> Dict[str, Any]:
        model = self._load_model(params)
        reader = self._score_reader()
        result: Dict[str, Any] = {}
        ds = model.transform(reader)
        scores = model._select_scores(ds)
        # evaluate only when the scoring data actually carries labels —
        # unlabeled production data must still score cleanly
        if self.evaluator is not None and self._has_labels(
                model, ds, params.response):
            result["metrics"] = model._evaluate_ds(ds, self.evaluator,
                                                   label=params.response)
        if params.score_location:
            path = os.path.join(params.score_location, "scores.csv")
            write_scores_csv(scores, path)
            result["scoreLocation"] = path
        result["nRows"] = scores.n_rows
        return result

    def _run_streaming_score(self, params: OpParams) -> Dict[str, Any]:
        """Chunked scoring: host records stream in chunks through the
        fused scorer; scores append to CSV incrementally, so
        memory stays bounded by the chunk size regardless of file size."""
        model = self._load_model(params)
        reader = self._score_reader()
        chunk_rows = int(params.custom_params.get("chunkRows", 50_000))
        scorer = model.compile_scoring()
        from .readers import DataReaders

        path = None
        if params.score_location:
            path = os.path.join(params.score_location, "scores.csv")
        total = 0
        n_chunks = 0
        pred_cols = None
        for chunk in _iter_reader_chunks(reader, chunk_rows):
            n_valid = len(chunk)
            if 0 < n_valid < chunk_rows and n_chunks > 0:
                # pad the ragged final chunk to the chunk shape (every
                # chunk scores at one shape); padded rows are sliced
                # off below
                chunk = chunk + [chunk[-1]] * (chunk_rows - n_valid)
            scored = scorer.score(DataReaders.simple(chunk))
            scores = model._select_scores(scored)
            if scores.n_rows > n_valid:
                scores = Dataset(
                    {n: scores.column(n)[:n_valid]
                     for n in scores.column_names},
                    {n: scores.ftype(n) for n in scores.column_names})
            if path:
                pred_cols = write_scores_csv(scores, path,
                                             append=n_chunks > 0,
                                             pred_cols=pred_cols)
            total += scores.n_rows
            n_chunks += 1
        result: Dict[str, Any] = {"nRows": total, "nChunks": n_chunks,
                                  "chunkRows": chunk_rows}
        if path:
            result["scoreLocation"] = path
        return result

    def _run_evaluate(self, params: OpParams) -> Dict[str, Any]:
        model = self._load_model(params)
        if self.evaluator is None:
            raise ValueError("runner needs an evaluator for EVALUATE")
        return {"metrics": model.evaluate(self._score_reader(),
                                          self.evaluator,
                                          label=params.response)}

    def _run_features(self, params: OpParams) -> Dict[str, Any]:
        reader = self.score_reader or self.train_reader
        if reader is None:
            raise ValueError("runner needs a reader for FEATURES")
        has_saved = params.model_location and os.path.exists(
            os.path.join(params.model_location, "workflow.json"))
        if getattr(self, "_model", None) is not None or has_saved:
            raw = self._load_model(params).raw_features  # corruption raises
        else:  # no model anywhere: derive raw features from the workflow
            from .workflow import compute_dag
            raw, _ = compute_dag(self.workflow.result_features)
        from .stages.generator import raw_dataset_for
        ds = raw_dataset_for(reader, raw)
        result: Dict[str, Any] = {"nRows": ds.n_rows,
                                  "columns": ds.column_names}
        if params.score_location:
            path = os.path.join(params.score_location, "features.csv")
            write_scores_csv(ds, path)
            result["featuresLocation"] = path
        return result
