"""Project generator + batch CLI.

Reference: cli/src/main/scala/com/salesforce/op/cli/ (`transmogrifai
gen`: schema + CSV -> a generated project with typed Features and a
runner app; CliExec, ProblemSchema, templates/simple). Here the schema
comes from the input file itself — CSV inference, the Parquet/Arrow
schema, or the Avro container schema — and the generated project is
three files: features.py (typed declarations), app.py (train/score
entry), params.yaml.

Usage:
    python -m transmogrifai_tpu_torch gen --input data.csv --response label \
        [--id id] [--name MyProject] --output-dir proj/
    python -m transmogrifai_tpu_torch run --params proj/params.yaml \
        --run-type train   (shorthand: exec the generated app)
    python -m transmogrifai_tpu_torch serve --model model_dir --input new.csv \
        --output scores.csv   (bucketed, double-buffered stream scoring)
    python -m transmogrifai_tpu_torch serve --engine --model model_dir \
        --input requests.jsonl --output responses.jsonl [--replicas N] \
        [--continuum-project proj/]   (micro-batching engine / fleet)

Every command that trains or scores runs on the card unless ``--device``
names another (``--device cpu``: the host) — the counterpart of the
``JAX_PLATFORMS`` a user of the JAX package sets; without CUDA and
without ``--device`` it fails loudly instead of falling back.
``TM_TRACE_DIR`` records a ``torch.profiler`` trace of ``run`` and
``serve`` (``profiling.trace``) beside the request span exports.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Type

from .features import types as ft
from .readers import infer_csv_schema

_FEATURES_TEMPLATE = '''"""Typed feature declarations for {name} (generated by
`transmogrifai_tpu_torch gen`; edit types as needed)."""
from transmogrifai_tpu_torch import FeatureBuilder
from transmogrifai_tpu_torch.features import types as ft

SCHEMA = {{
{schema_lines}
}}

RESPONSE = {response!r}
ID_COLUMN = {id_col!r}
# classification labels (text, boolean, or arbitrary numerics like 1/2)
# are indexed to 0..k-1 by the app before training
RESPONSE_INDEXED = {indexed}

response = FeatureBuilder.of(ft.RealNN, RESPONSE).from_column().as_response()
predictors = [
    FeatureBuilder.of(t, n).from_column().as_predictor()
    for n, t in SCHEMA.items()
    if n != RESPONSE and n != ID_COLUMN
]
'''

_APP_TEMPLATE = '''"""Runner app for {name} (generated by `transmogrifai_tpu_torch gen`)."""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

from transmogrifai_tpu_torch import models as M
from transmogrifai_tpu_torch.evaluators import Evaluators
from transmogrifai_tpu_torch.ops.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.ops.transmogrifier import (transmogrify,
                                                  transmogrify_sparse)
from transmogrifai_tpu_torch.readers import DataReaders
from transmogrifai_tpu_torch.runner import OpParams, RunType, WorkflowRunner
from transmogrifai_tpu_torch.workflow import Workflow

import features

{workflow_build}


def _label_sort_key(v):
    try:
        return (0, float(v), "")
    except (TypeError, ValueError):
        return (1, 0.0, str(v))


def _make_reader(path, label_map=None):
    reader = {reader_line}
    if not features.RESPONSE_INDEXED:
        return reader, label_map
    records = reader.read()
    if label_map is None:
        seen = {{r[features.RESPONSE] for r in records
                if r.get(features.RESPONSE) is not None}}
        label_map = {{v: float(i) for i, v in
                     enumerate(sorted(seen, key=_label_sort_key))}}
    for r in records:
        # unseen score-time labels become missing (rows still score)
        r[features.RESPONSE] = label_map.get(r.get(features.RESPONSE))
    return DataReaders.simple(records, key=features.ID_COLUMN), label_map


def main(run_type="train", params_path=None, device=None):
    # device: None trains and scores on the card (CUDA, failing
    # without it); "cpu" on the host
    here = os.path.dirname(os.path.abspath(__file__))
    params = OpParams.from_file(params_path or os.path.join(here,
                                                            "params.yaml"))
    reader, labels = _make_reader(params.train_reader_path)
    score_reader = None
    if run_type != "train":  # train never touches the score reader
        score_reader, _ = _make_reader(
            params.score_reader_path or params.train_reader_path, labels)
    runner = WorkflowRunner(build_workflow(), train_reader=reader,
                            score_reader=score_reader,
                            evaluator=Evaluators.{evaluator}(),
                            device=device)
    result = runner.run(RunType(run_type), params)
    print(result)
    return result


if __name__ == "__main__":
    main(*sys.argv[1:3])
'''

_DENSE_BUILD = '''def build_workflow():
    fv = transmogrify(features.predictors)
    checked = SanityChecker().set_input(features.response, fv).output
    prediction = M.{selector}.with_cross_validation(
        n_folds=3).set_input(features.response, checked).output
    return Workflow([prediction])
'''

# Criteo-scale variant: categorical columns hash into one shared sparse
# space, the sparse selector grid-validates + streaming-refits hashed LR
_SPARSE_BUILD = '''def build_workflow():
    hashed, dense = transmogrify_sparse(features.predictors,
                                        num_buckets={buckets})
    here = os.path.dirname(os.path.abspath(__file__))
    prediction = M.SparseModelSelector(
        num_buckets={buckets},
        # a killed refit resumes at the last mid-stream checkpoint
        checkpoint_dir=os.path.join(here, "refit_checkpoint"),
    ).set_input(features.response, hashed, dense).output
    return Workflow([prediction])
'''

_PARAMS_TEMPLATE = '''trainReaderPath: {csv_path}
modelLocation: {out_dir}/model
metricsLocation: {out_dir}/metrics
scoreLocation: {out_dir}/scores
# the CUDA kernels' build cache: every run after the first loads the
# kernels built by an earlier one instead of compiling them again
compilationCacheLocation: {out_dir}/kernel_cache
'''


_FORMATS = {".csv": "csv", ".tsv": "csv", ".parquet": "parquet",
            ".pq": "parquet", ".avro": "avro"}


def _input_format(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    if ext not in _FORMATS:
        raise ValueError(f"unsupported input format {ext!r} "
                         f"(expected one of {sorted(_FORMATS)})")
    return _FORMATS[ext]


def _infer_schema(path: str):
    """(format, FeatureType schema) for a CSV/Parquet/Avro input file.
    Reference: the CLI generator consumes Avro schemas (cli/ProblemSchema);
    here every supported reader format self-describes."""
    fmt = _input_format(path)
    if fmt == "csv":
        return fmt, infer_csv_schema(path)
    if fmt == "parquet":
        from .readers.formats import infer_parquet_schema
        return fmt, infer_parquet_schema(path)
    from .readers.formats import infer_avro_schema, read_avro
    avro_schema, _ = read_avro(path, max_records=0)  # header only
    return fmt, infer_avro_schema(avro_schema)


def _sample_response(fmt: str, path: str, schema, response: str,
                     n: int) -> list:
    """First n non-null response values without materializing the file."""
    if fmt == "csv":
        import csv as csvmod
        from .readers.core import _parse_cell
        vals = []
        with open(path, newline="") as fh:
            rows = csvmod.reader(fh)
            header = [h.strip() for h in next(rows)]
            idx = header.index(response)
            for i, row in enumerate(rows):
                if i >= n:
                    break
                if idx < len(row):
                    vals.append(_parse_cell(row[idx], schema[response]))
        return [v for v in vals if v is not None]
    if fmt == "parquet":
        import pyarrow.parquet as pq
        pf = pq.ParquetFile(path)
        vals = []
        # batch_size is a MAX per batch (row-group bounded): keep pulling
        # batches until n rows are seen, not just the first batch
        for batch in pf.iter_batches(batch_size=n, columns=[response]):
            vals.extend(v for v in batch.column(response).to_pylist()
                        if v is not None)
            if len(vals) >= n:
                break
        return vals[:n]
    from .readers.formats import read_avro
    _, records = read_avro(path, max_records=n)
    return [r.get(response) for r in records if r.get(response) is not None]


def _reader_line(fmt: str) -> str:
    """The reader construction line baked into the generated app.py."""
    if fmt == "avro":
        return ("DataReaders.avro(path, schema=features.SCHEMA, "
                "key=features.ID_COLUMN)")
    return (f"DataReaders.{fmt}(path, features.SCHEMA, "
            f"key=features.ID_COLUMN)")


def infer_problem_type(path: str, response: str,
                       sample_rows: int = 2000,
                       fmt_schema=None) -> str:
    """binary / multiclass / regression from the response column values
    (any supported input format; only the first sample_rows are read).
    `fmt_schema` passes an already-inferred (format, schema) so callers
    like generate_project don't re-infer."""
    fmt, schema = fmt_schema or _infer_schema(path)
    if response not in schema:
        raise ValueError(f"response column {response!r} not in "
                         f"{path} columns {sorted(schema)}")
    vals = _sample_response(fmt, path, schema, response, sample_rows)
    import math
    try:
        nums = sorted({float(v) for v in vals})
        if any(not math.isfinite(v) for v in nums):
            nums = None  # inf tokens: not a usable numeric label
    except (ValueError, TypeError, OverflowError):
        nums = None
    if nums is not None:
        if len(nums) <= 2:
            return "binary"
        if len(nums) <= 20 and all(v == int(v) for v in nums):
            return "multiclass"
        return "regression"
    k = len({str(v) for v in vals})
    return "binary" if k <= 2 else "multiclass"


_SELECTORS = {
    "binary": ("BinaryClassificationModelSelector", "binary_classification"),
    "multiclass": ("MultiClassificationModelSelector", "multi_classification"),
    "regression": ("RegressionModelSelector", "regression"),
}


def generate_project(csv_path: str, response: str, output_dir: str,
                     id_col: Optional[str] = None, name: Optional[str] = None,
                     problem: Optional[str] = None, sparse: bool = False,
                     num_buckets: int = 1 << 20) -> Dict[str, str]:
    """Write features.py / app.py / params.yaml; returns {file: path}.
    Input may be CSV, Parquet, or Avro (format from the extension).
    `sparse=True` generates the Criteo-scale app (hashed shared space +
    SparseModelSelector; binary problems only)."""
    csv_path = os.path.abspath(csv_path)
    fmt, schema = _infer_schema(csv_path)
    if response not in schema:
        raise ValueError(f"response {response!r} not in input columns "
                         f"{sorted(schema)}")
    inferred_resp = schema[response]
    problem = problem or infer_problem_type(csv_path, response,
                                            fmt_schema=(fmt, schema))
    if problem not in _SELECTORS:
        raise ValueError(f"unknown problem type {problem!r}")
    # classification labels are indexed to 0..k-1 by the generated app
    # (handles text/boolean labels AND numeric codings like 1/2); the
    # CSV schema keeps the inferred cell type so parsing still works
    indexed = problem in ("binary", "multiclass")
    if issubclass(inferred_resp, ft.OPNumeric) and \
            not issubclass(inferred_resp, ft.Binary):
        schema[response] = ft.RealNN
    if id_col is not None and id_col not in schema:
        raise ValueError(f"id column {id_col!r} not in CSV columns")
    if id_col:
        schema[id_col] = ft.ID
    selector, evaluator = _SELECTORS[problem]
    if sparse and problem != "binary":
        raise ValueError("--sparse generates the hashed-LR app, which is "
                         f"binary-only (inferred problem: {problem!r})")
    build = (_SPARSE_BUILD.format(buckets=int(num_buckets)) if sparse
             else _DENSE_BUILD.format(selector=selector))
    name = name or os.path.splitext(os.path.basename(csv_path))[0].title()

    os.makedirs(output_dir, exist_ok=True)
    schema_lines = "\n".join(
        f"    {n!r}: ft.{t.__name__}," for n, t in schema.items())
    files = {
        "features.py": _FEATURES_TEMPLATE.format(
            name=name, schema_lines=schema_lines, response=response,
            id_col=id_col, indexed=indexed),
        "app.py": _APP_TEMPLATE.format(name=name, evaluator=evaluator,
                                       reader_line=_reader_line(fmt),
                                       workflow_build=build),
        "params.yaml": _PARAMS_TEMPLATE.format(
            csv_path=csv_path, out_dir=os.path.abspath(output_dir)),
    }
    out = {}
    for fname, content in files.items():
        path = os.path.join(output_dir, fname)
        with open(path, "w") as f:
            f.write(content)
        out[fname] = path
    return out


def _parse_bucket_spec(spec: str):
    """'default'/'on' -> the default bucket set, 'off'/'none' -> per-shape
    jit, else comma-separated bucket sizes ('256,1024,4096')."""
    if spec.lower() in ("default", "on", "true"):
        return True
    if spec.lower() in ("off", "none"):
        return None
    from .workflow import _normalize_buckets
    try:
        return _normalize_buckets(
            tuple(int(x) for x in spec.split(",") if x.strip()))
    except ValueError:
        raise ValueError(f"--buckets expects 'default', 'off', or "
                         f"comma-separated positive ints, got {spec!r}"
                         ) from None


def serve_stream(model_dir: str, input_path: str, output_path: str,
                 chunk_rows: int = 8192, buckets="default",
                 buffer_size: int = 2,
                 stats_json: Optional[str] = None, device=None) -> Dict:
    """Serving entry: stream a CSV through the bucketed, double-buffered
    fused scoring pipeline (workflow.FusedScorer.score_stream) and append
    scores to `output_path` chunk by chunk — memory stays bounded by the
    chunk size, the compile universe by the bucket set, and host parsing
    overlaps device compute. Returns (and prints, as the last stdout
    line) a JSON summary with the per-bucket ScoringStats.

    `buckets` takes a CLI spec string (see _parse_bucket_spec; the CLI
    default is 'default'), or the compile_scoring values directly
    (True / a tuple / None = per-shape jit) — the same sentinel meanings
    as FusedScorer. ``device``: where the model scores (None: CUDA,
    failing without it)."""
    import time

    import numpy as np

    from .dataset import Dataset
    from .io.stream import csv_chunks
    from .workflow import WorkflowModel

    import csv as _csv

    if isinstance(buckets, str):
        buckets = _parse_bucket_spec(buckets)   # fail BEFORE the load
    model = WorkflowModel.load(model_dir, device=device)
    scorer = model.compile_scoring(buckets=buckets, device=device)
    with open(input_path, newline="") as f:
        try:
            raw_header = next(_csv.reader(f))
        except StopIteration:
            raise ValueError(f"{input_path} is empty (no header row)"
                             ) from None
    # match features by whitespace-stripped header names, but key the
    # parse schema by the RAW fieldnames (DictReader keys): a padded
    # header like 'x0, x1' must not silently parse x1 as all-null
    by_stripped = {}
    for h in raw_header:
        by_stripped.setdefault(h.strip(), h)
    schema = {}        # raw fieldname -> wtype, for csv_chunks
    rename = {}        # raw fieldname -> feature name
    for feat in model.raw_features:
        raw = by_stripped.get(feat.name)
        if raw is not None:
            schema[raw] = feat.wtype
            rename[raw] = feat.name
    missing = [f.name for f in model.raw_features
               if not f.is_response and f.name not in by_stripped]
    if missing:
        raise ValueError(f"{input_path} is missing predictor columns "
                         f"{missing}")
    # label-free serving: response columns absent from the file ride as
    # zero placeholders (the same contract as FusedScorer's boundary)
    absent_resp = [f for f in model.raw_features
                   if f.is_response and f.name not in by_stripped]

    def chunks():
        for cols in csv_chunks(input_path, schema, chunk_rows=chunk_rows):
            n = len(next(iter(cols.values()))) if cols else 0
            full = {rename[k]: v for k, v in cols.items()}
            sch = {rename[k]: t for k, t in schema.items()}
            for f in absent_resp:
                full[f.name] = np.zeros(n, np.float64)
                sch[f.name] = f.wtype
            yield Dataset(full, sch)

    def write_header(wr, res):
        cols_hdr = []
        for nm in res:
            a = np.asarray(res[nm])
            cols_hdr.extend([f"{nm}_{j}" for j in range(a.shape[1])]
                            if a.ndim == 2 else [nm])
        wr.writerow(cols_hdr)

    total = 0
    wrote_header = False
    t0 = time.perf_counter()
    with open(output_path, "w", newline="") as out_f:
        wr = _csv.writer(out_f)
        for res in scorer.score_stream(chunks(), buffer_size=buffer_size):
            arrs = [np.asarray(res[nm]) for nm in res]
            if not wrote_header:
                write_header(wr, res)
                wrote_header = True
            n = arrs[0].shape[0] if arrs else 0
            if n:
                # one vectorized block per chunk: a per-scalar Python
                # row loop here would serialize with (and starve) the
                # double-buffered pipeline
                block = np.column_stack(
                    [a if a.ndim == 2 else a[:, None] for a in arrs])
                wr.writerows(block.tolist())
            total += n
        if not wrote_header:
            # header-only input: still emit the documented column header
            # by scoring a zero-row chunk (a bucketed scorer pads it to
            # its smallest bucket, so no extra program compiles)
            from .dataset import column_to_numpy
            full = {rename[k]: column_to_numpy([], t)
                    for k, t in schema.items()}
            sch = {rename[k]: t for k, t in schema.items()}
            for f in absent_resp:
                full[f.name] = np.zeros(0, np.float64)
                sch[f.name] = f.wtype
            write_header(wr, scorer.score_arrays(Dataset(full, sch)))
    dt = time.perf_counter() - t0
    summary = {
        "rows": total, "seconds": dt,
        "rows_per_sec": total / dt if dt > 0 else None,
        "output": os.path.abspath(output_path),
        "buckets": list(scorer.buckets) if scorer.buckets else None,
        "stats": scorer.stats.as_dict(),
    }
    if stats_json:
        with open(stats_json, "w") as f:
            json.dump(summary, f, indent=1, default=float)
    print(json.dumps(summary, default=float))
    return summary


def _request_columns(obj) -> Dict:
    """One parsed JSONL request line -> {column: list-of-values}.

    Accepted shapes: {"columns": {col: [...]}}, a bare {col: [...]}
    column dict, a single-row {col: scalar} dict, or a list of row
    objects — whatever the upstream RPC layer finds natural."""
    if isinstance(obj, dict) and isinstance(obj.get("columns"), dict):
        obj = obj["columns"]
    if isinstance(obj, list):
        cols: Dict[str, list] = {}
        for row in obj:
            if not isinstance(row, dict):
                raise ValueError("request row entries must be objects")
            for k, v in row.items():
                cols.setdefault(k, []).append(v)
        if not cols:
            raise ValueError("request row list is empty")
        return cols
    if isinstance(obj, dict) and obj:
        if all(not isinstance(v, (list, tuple)) for v in obj.values()):
            return {k: [v] for k, v in obj.items()}
        return {k: list(v) if isinstance(v, (list, tuple)) else [v]
                for k, v in obj.items()}
    raise ValueError(f"unsupported request shape: {type(obj).__name__}")


def serve_engine(model_dir: str, input_path: str, output_path: str,
                 clients: int = 8, max_wait_ms: float = 2.0,
                 max_batch_rows: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 buckets="default", stats_json: Optional[str] = None,
                 replicas: Optional[int] = None,
                 continuum_project: Optional[str] = None,
                 device=None) -> Dict:
    """Engine serving entry: JSONL requests in, JSONL responses out.

    Unlike `serve` (one sequential CSV stream), this mode emulates many
    concurrent callers: `--clients` threads submit requests to an
    in-process serving.ServingEngine, which coalesces them into
    micro-batches aligned to the model's shape buckets, applies
    admission control (`--deadline-ms` per-request deadlines), and
    scatters results back per request. Output lines keep input order;
    shed/rejected requests produce an `error` entry, never a silent
    gap. `--model` may be a saved WorkflowModel dir, a portable-export
    artifact, or a registry root (registry.json) — the default version
    serves.

    `--replicas N` (N > 1) serves through a supervised ServingFleet
    instead of one engine: N shared-nothing replicas behind the
    breaker-guarded failover router (TM_FLEET_* env vars configure
    breaker/failover/rollout thresholds); the summary's `status` block
    is then the aggregated fleet snapshot. With no explicit flag,
    `TM_FLEET_REPLICAS` picks the count (and so the mode) — a knob
    that parses fine but silently does nothing is exactly the failure
    the strict TM_FLEET_* convention forbids.

    `--continuum-project DIR` (a `gen`-erated project) additionally
    runs the self-healing continuous-learning loop over the serving
    traffic: the request plane feeds the drift monitor, a sustained
    breach triggers a checkpointed retrain via the project's
    `build_workflow()` on its params.yaml training data, the candidate
    is lint- and shadow-gated, and a pass promotes through the fleet's
    staged rollout (auto-rollback inherited). TM_DRIFT_* /
    TM_CONTINUUM_* env vars tune the loop (strict parsing); the
    summary's `status.continuum` block records what the loop did.

    ``device``: where every replica (and the continuum retrain) runs
    (None: CUDA, failing without it)."""
    import time

    import numpy as np

    from .dataset import Dataset, column_to_numpy
    from .serving import (EngineConfig, FleetConfig, ServingEngine,
                          ServingFleet)
    from .serving.registry import build_registry

    # STRICT TM_FLEET_* validation even when single-engine mode wins: a
    # typo'd or unparsable knob must fail the deploy, not silently drop
    env_cfg = (FleetConfig.from_env()
               if any(k.startswith("TM_FLEET_") for k in os.environ)
               else None)
    if replicas is None:
        replicas = (env_cfg.replicas
                    if env_cfg is not None
                    and "TM_FLEET_REPLICAS" in os.environ else 1)
    if isinstance(buckets, str):
        buckets = _parse_bucket_spec(buckets)
    # from_env: the TM_TENANT_* / TM_MODEL_* multi-model knobs apply
    # (and are strictly validated) in CLI serving too — a typo'd
    # fairness knob must fail the deploy, not silently run flat
    config = EngineConfig.from_env(max_batch_rows=max_batch_rows,
                                   max_wait_ms=max_wait_ms)
    # register WITHOUT warming: zero-filled warm data carries the
    # wrong dtypes for integer boundary columns (hashed sparse
    # indices) — the first parsed request warms below instead
    if replicas > 1:
        # env_cfg (already strictly validated above) rides along so the
        # 18 knobs aren't parsed a second time by the constructor
        server = ServingFleet(model_dir, replicas=replicas,
                              buckets=buckets, warm=False,
                              config=env_cfg, engine_config=config,
                              device=device)
        backends = [h.engine.registry.get().backend
                    for h in server.replica_handles()]
    else:
        registry = build_registry(model_dir, buckets=buckets, warm=False,
                                  device=device)
        server = ServingEngine(registry=registry, config=config)
        backends = [server.registry.get().backend]
    backend = backends[0]

    def to_request_data(cols: Dict[str, list]):
        lens = {k: len(v) for k, v in cols.items()}
        if len(set(lens.values())) > 1:
            raise ValueError(f"ragged request columns: {lens}")
        if backend.kind != "workflow":
            return {k: np.asarray(v) for k, v in cols.items()}
        model = backend.scorer.model
        n = next(iter(lens.values()))
        full, sch = {}, {}
        for f in model.raw_features:
            if f.name in cols:
                full[f.name] = column_to_numpy(cols[f.name], f.wtype)
            elif f.is_response:
                full[f.name] = np.zeros(n, np.float64)
            else:
                raise ValueError(
                    f"request missing predictor column {f.name!r}")
            sch[f.name] = f.wtype
        return Dataset(full, sch)

    controller = None
    if continuum_project:
        controller = _build_continuum(server, backend, continuum_project,
                                      buckets=buckets,
                                      device=backend.scorer.device
                                      if backend.kind == "workflow"
                                      else device)

    # STREAMING execution: the input JSONL is read lazily through a
    # bounded work queue and responses write out in input order as they
    # complete — memory stays O(clients + in-flight), not O(file), the
    # same bounded-memory contract the CSV serve path advertises.
    import queue as _queue
    import threading as _threading

    n_workers = max(1, clients)
    work_q: "_queue.Queue" = _queue.Queue(maxsize=n_workers * 4)
    results: Dict[int, Dict] = {}
    res_cv = _threading.Condition()
    totals = {"ok": 0, "rows": 0}

    def call(i: int, data):
        t0 = time.perf_counter()
        try:
            res = server.score(data, deadline_ms=deadline_ms)
            ms = (time.perf_counter() - t0) * 1e3
            entry = {
                "id": i, "latency_ms": ms,
                "rows": int(next(iter(res.values())).shape[0]) if res else 0,
                "results": {k: np.asarray(v).tolist()
                            for k, v in res.items()}}
        except Exception as e:     # noqa: BLE001 — per-request error
            # entry, never a lost line: scoring/backend errors surface
            # on the future exactly like sheds/rejections
            entry = {"id": i, "error": str(e),
                     "error_type": type(e).__name__}
        with res_cv:
            results[i] = entry
            res_cv.notify_all()

    def worker():
        while True:
            item = work_q.get()
            if item is None:
                return
            call(*item)

    t_start = time.perf_counter()
    n_requests = 0
    with server, open(output_path, "w") as out_f:
        if controller is not None:
            controller.start()
        next_w = 0

        def flush_ready(block_until: Optional[int] = None):
            nonlocal next_w
            with res_cv:
                while True:
                    while next_w in results:
                        entry = results.pop(next_w)
                        if "error" not in entry:
                            totals["ok"] += 1
                            totals["rows"] += entry["rows"]
                        out_f.write(json.dumps(entry, default=float) + "\n")
                        next_w += 1
                    if block_until is None or next_w >= block_until:
                        return
                    res_cv.wait(0.1)

        workers = [_threading.Thread(target=worker, daemon=True)
                   for _ in range(n_workers)]
        for w in workers:
            w.start()
        try:
            with open(input_path) as f:
                for ln, line in enumerate(f, start=1):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        data = to_request_data(
                            _request_columns(json.loads(line)))
                    except ValueError as e:
                        raise ValueError(
                            f"{input_path} line {ln}: {e}") from e
                    if n_requests == 0:
                        # warm bucket compiles off the hot path, with
                        # REAL boundary dtypes (the first request),
                        # before any client thread scores — every
                        # replica's backend in fleet mode
                        for b in backends:
                            b.warm(data)
                    work_q.put((n_requests, data))   # bounded parse-ahead
                    n_requests += 1
                    flush_ready()
        finally:
            for _ in workers:
                work_q.put(None)
            for w in workers:
                w.join()
        flush_ready(block_until=n_requests)
        if controller is not None:
            # stop BEFORE the engines drain: an in-flight cycle finishes
            # its phase, and the summary carries the loop's full story
            controller.stop()
            status = controller.status()
        else:
            status = server.status()
    dt = time.perf_counter() - t_start
    summary = {"requests": n_requests, "ok": totals["ok"],
               "errors": n_requests - totals["ok"], "rows": totals["rows"],
               "seconds": dt,
               "rows_per_sec": totals["rows"] / dt if dt > 0 else None,
               "output": os.path.abspath(output_path), "status": status}
    # TM_TRACE_DIR + TM_TRACE_SAMPLE: export this serve's request spans
    # (Chrome trace JSON for Perfetto + JSONL for grep) alongside the
    # torch.profiler device trace the same knob captured
    trace_dir = os.environ.get("TM_TRACE_DIR")
    from .telemetry.spans import TRACER
    if trace_dir and TRACER.enabled:
        summary["spanTraces"] = {
            "chrome": TRACER.export_chrome(
                os.path.join(trace_dir, "tm_spans.json")),
            "jsonl": TRACER.export_jsonl(
                os.path.join(trace_dir, "tm_spans.jsonl"))}
    if stats_json:
        with open(stats_json, "w") as f:
            json.dump(summary, f, indent=1, default=float)
    print(json.dumps(summary, default=float))
    return summary


def _build_continuum(server, backend, project_dir: str, buckets=True,
                     device=None):
    """Wire the self-healing continuous-learning loop over a serving
    surface from a generated project: ``build_workflow()`` is the
    retrain factory, the params.yaml training reader is the retrain
    data (and the fallback drift baseline when the served artifact
    carries no rawFeatureFilter train distributions)."""
    if getattr(backend, "kind", None) != "workflow":
        raise ValueError(
            "--continuum-project needs the served --model to be a saved "
            "WorkflowModel artifact (the drift baseline + retrain "
            "anchor); portable exports carry no fitted workflow to "
            "anchor on")
    app = _import_project_app(project_dir)
    from .runner import OpParams
    params = OpParams.from_file(os.path.join(os.path.abspath(project_dir),
                                             "params.yaml"))
    reader, _ = app._make_reader(params.train_reader_path)
    from .continuum import ContinuumController
    return ContinuumController(server, backend.scorer.model,
                               app.build_workflow, reader,
                               baseline_data=reader, buckets=buckets,
                               device=device)


def _import_project_app(project_dir: str):
    """Import a generated project's app module (same mechanics as the
    `run` subcommand: path insert + stale module eviction)."""
    app_dir = os.path.abspath(project_dir)
    if not os.path.exists(os.path.join(app_dir, "app.py")):
        raise ValueError(f"{project_dir}: no app.py — not a generated "
                         f"project (run `gen` first)")
    sys.path.insert(0, app_dir)
    import importlib
    for mod in ("features", "app"):
        if mod in sys.modules:
            del sys.modules[mod]
    return importlib.import_module("app")


def lint_target(project: Optional[str] = None, model: Optional[str] = None,
                module: Optional[str] = None, ast_checks: bool = True):
    """Resolve one `lint` CLI target to a LintReport.

    Exactly one of `project` (a generated project dir whose
    build_workflow() is linted), `model` (a saved workflow dir, portable
    export, or registry root), or `module` ("pkg.mod:attr" resolving to
    a Workflow / feature(s) / zero-arg factory).
    """
    from .lint import lint_artifact, lint_workflow

    picked = [x for x in (project, model, module) if x]
    if len(picked) != 1:
        raise ValueError("lint needs exactly one of --project / --model "
                         "/ --module")
    if model:
        return lint_artifact(model, ast_checks=ast_checks)
    if project:
        app = _import_project_app(project)
        return lint_workflow(app.build_workflow(), ast_checks=ast_checks)
    import importlib
    mod_name, _, attr = module.partition(":")
    if not attr:
        raise ValueError(f"--module expects 'pkg.mod:attr', got {module!r}")
    target = getattr(importlib.import_module(mod_name), attr)
    if callable(target) and not hasattr(target, "result_features"):
        target = target()
    return lint_workflow(target, ast_checks=ast_checks)


def lint_main(args) -> int:
    """`lint` subcommand body: print the report, exit non-zero on any
    error-severity finding (the CI gate contract)."""
    report = lint_target(project=args.project, model=args.model,
                         module=args.module, ast_checks=not args.no_ast)
    if args.format == "json":
        print(json.dumps(report.as_dict(), indent=1))
    else:
        print(report.format_text())
    return 1 if report.has_errors else 0


def _format_flight_event(e: Dict) -> str:
    """One flight-recorder event -> a grep-friendly text line."""
    import datetime
    ts = datetime.datetime.fromtimestamp(e.get("wall", 0.0))
    parts = [ts.strftime("%H:%M:%S.%f")[:-3],
             f"[{e.get('severity', '?'):7}]",
             f"{e.get('subsystem', '?')}.{e.get('event', '?')}"]
    if e.get("trace"):
        parts.append(f"trace={e['trace']}")
    for k, v in (e.get("attrs") or {}).items():
        parts.append(f"{k}={v}")
    return " ".join(parts)


def telemetry_main(args) -> int:
    """`telemetry` subcommand body: inspect a flight-recorder dump
    (filter by trace id / subsystem / severity, text or JSON) and
    convert span JSONL exports to Perfetto-openable Chrome trace JSON
    — the post-incident reader for the artifacts the serving stack
    auto-dumps (docs/OBSERVABILITY.md)."""
    from .telemetry.recorder import default_dump_path, load_dump
    from .telemetry.spans import jsonl_to_chrome

    did_anything = False
    if args.spans:
        if not args.chrome_out:
            raise ValueError("--spans needs --chrome-out OUT.json (the "
                             "JSONL itself is already greppable)")
        out = jsonl_to_chrome(args.spans, args.chrome_out)
        print(f"wrote Chrome trace {out} — open it in ui.perfetto.dev "
              f"or chrome://tracing")
        did_anything = True
    if args.flight or not did_anything:
        path = args.flight or default_dump_path()
        if not os.path.exists(path):
            raise ValueError(
                f"no flight-recorder dump at {path} — pass --flight "
                f"PATH (dumps land in TM_FLIGHT_DIR, default the "
                f"system tempdir, on rollback/crash/fleet-stop)")
        events = load_dump(path)
        from .telemetry.recorder import SEVERITIES
        if args.subsystem:
            events = [e for e in events
                      if e.get("subsystem") == args.subsystem]
        if args.severity:
            floor = SEVERITIES.index(args.severity)
            events = [e for e in events
                      if SEVERITIES.index(e.get("severity", "info"))
                      >= floor]
        if args.trace:
            events = [e for e in events if e.get("trace") == args.trace]
        if args.tail:
            events = events[-args.tail:]
        if args.format == "json":
            print(json.dumps(events, indent=1, default=str))
        else:
            for e in events:
                print(_format_flight_event(e))
            print(f"-- {len(events)} events from {path}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="transmogrifai_tpu_torch",
        description="AutoML for structured data on PyTorch/CUDA: "
                    "project generator, batch runner and serving")
    sub = parser.add_subparsers(dest="command", required=True)

    g = sub.add_parser("gen", help="generate a typed project from a CSV/Parquet/Avro file")
    g.add_argument("--input", required=True, help="training data path (.csv / .parquet / .avro)")
    g.add_argument("--response", required=True, help="label column")
    g.add_argument("--id", dest="id_col", default=None, help="id column")
    g.add_argument("--name", default=None, help="project name")
    g.add_argument("--problem", default=None,
                   choices=["binary", "multiclass", "regression"],
                   help="override inferred problem type")
    g.add_argument("--sparse", action="store_true",
                   help="generate the Criteo-scale hashed-sparse app "
                        "(shared hash space + SparseModelSelector; "
                        "binary only)")
    g.add_argument("--num-buckets", type=int, default=1 << 20,
                   help="hash-space width for --sparse (default 2^20)")
    g.add_argument("--output-dir", required=True)

    r = sub.add_parser("run", help="run a generated project app")
    r.add_argument("--params", required=True, help="params.yaml path")
    r.add_argument("--run-type", default="train",
                   choices=["train", "score", "evaluate", "features", "streaming_score"])
    r.add_argument("--profile", action="store_true",
                   help="print the per-stage training executor profile "
                        "(fit/transform wall time, rows/s, fused vs host "
                        "vs pruned transforms, pool occupancy), the "
                        "per-layer Amdahl split (serialFraction), and "
                        "the fused-sweep program compile-vs-execute "
                        "attribution; the same data always lands in "
                        "train_summaries['stageTimings']")
    r.add_argument("--executor", default=None,
                   choices=["parallel", "serial"],
                   help="workflow training executor (default: "
                        "TM_WORKFLOW_EXECUTOR or 'parallel')")
    r.add_argument("--checkpoint-dir", default=None,
                   help="durable train checkpointing: fitted stage "
                        "state persists after every DAG layer, and a "
                        "killed train re-run with the same arguments "
                        "resumes at the first unfinished layer "
                        "(docs/RESILIENCE.md); same as TM_TRAIN_CKPT")
    r.add_argument("--resume", action="store_true",
                   help="REQUIRE a resumable checkpoint under "
                        "--checkpoint-dir: fail loudly instead of "
                        "silently training from scratch when the "
                        "checkpoint is missing")
    r.add_argument("--device", default=None,
                   help="torch device to train and score on (default: "
                        "cuda, failing without it; 'cpu' for the host)")
    r.add_argument("--faults", default=None, metavar="SPEC",
                   help="arm the deterministic fault-injection harness "
                        "(TM_FAULTS grammar: 'point:kind:nth[:arg]', "
                        "';'-separated; see docs/RESILIENCE.md)")

    s = sub.add_parser("serve", help="stream-score a CSV through the "
                                     "bucketed fused serving pipeline")
    s.add_argument("--model", required=True, help="saved WorkflowModel dir")
    s.add_argument("--input", required=True, help="CSV to score")
    s.add_argument("--output", required=True, help="scores CSV to write")
    s.add_argument("--chunk-rows", type=int, default=8192,
                   help="rows per streamed chunk (default 8192)")
    s.add_argument("--buckets", default="default",
                   help="'default', 'off', or comma-separated pad-bucket "
                        "sizes (e.g. 1024,4096,16384)")
    s.add_argument("--buffer-size", type=int, default=2,
                   help="chunks in flight (host prefetch + device overlap)")
    s.add_argument("--stats-json", default=None,
                   help="also write the summary/stats JSON to this path")
    s.add_argument("--device", default=None,
                   help="torch device to serve on (default: cuda, "
                        "failing without it; 'cpu' for the host)")
    s.add_argument("--engine", action="store_true",
                   help="serving-engine mode: --input is JSONL requests "
                        "scored CONCURRENTLY through the micro-batching "
                        "engine (admission control, per-request "
                        "deadlines); --output is JSONL responses")
    s.add_argument("--clients", type=int, default=8,
                   help="concurrent client threads in --engine mode")
    s.add_argument("--replicas", type=int, default=None,
                   help="--engine mode: serve through a supervised "
                        "N-replica fleet (shared-nothing router, "
                        "per-replica circuit breakers, failover "
                        "re-dispatch; TM_FLEET_* env vars tune it). "
                        "Default: TM_FLEET_REPLICAS if set, else 1")
    s.add_argument("--continuum-project", default=None, metavar="DIR",
                   help="--engine mode: run the self-healing continuous-"
                        "learning loop over the serving traffic — drift-"
                        "triggered checkpointed retrain via this "
                        "generated project's build_workflow() and "
                        "params.yaml training data, lint + shadow "
                        "gating, staged promotion with auto-rollback "
                        "(TM_DRIFT_*/TM_CONTINUUM_* env vars tune it; "
                        "docs/CONTINUUM.md)")
    s.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="engine micro-batch flush deadline (ms)")
    s.add_argument("--max-batch-rows", type=int, default=None,
                   help="engine flush threshold (default: top bucket)")
    s.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request deadline in --engine mode; late "
                        "requests are shed/rejected, never silently "
                        "dropped")

    lp = sub.add_parser(
        "lint", help="opcheck: statically verify a workflow DAG / "
                     "serving artifact without fitting anything")
    lp.add_argument("--project", default=None,
                    help="generated project dir: lints "
                         "app.build_workflow()")
    lp.add_argument("--model", default=None,
                    help="saved workflow dir, portable export, or "
                         "registry root")
    lp.add_argument("--module", default=None,
                    help="'pkg.mod:attr' resolving to a Workflow or a "
                         "zero-arg workflow factory")
    lp.add_argument("--format", default="text", choices=["text", "json"])
    lp.add_argument("--no-ast", action="store_true",
                    help="skip the AST stage-purity layer (graph "
                         "checks only)")

    tp = sub.add_parser(
        "telemetry", help="inspect flight-recorder dumps and span "
                          "traces (docs/OBSERVABILITY.md)")
    tp.add_argument("--flight", default=None, metavar="DUMP.jsonl",
                    help="flight-recorder dump to read (default: this "
                         "host's TM_FLIGHT_DIR/tm_flight_<pid>.jsonl)")
    tp.add_argument("--tail", type=int, default=0,
                    help="only the last N events (after filters)")
    tp.add_argument("--trace", default=None,
                    help="only events correlated to this trace id")
    tp.add_argument("--subsystem", default=None,
                    help="only events from one subsystem (router, "
                         "fleet, continuum, faults, executor, engine)")
    tp.add_argument("--severity", default=None,
                    choices=["info", "warning", "error"],
                    help="minimum severity")
    tp.add_argument("--format", default="text", choices=["text", "json"])
    tp.add_argument("--spans", default=None, metavar="SPANS.jsonl",
                    help="a span JSONL export (TM_TRACE_DIR) to convert")
    tp.add_argument("--chrome-out", default=None, metavar="OUT.json",
                    help="write --spans as Chrome trace-event JSON "
                         "(open in ui.perfetto.dev)")

    args = parser.parse_args(argv)
    if args.command == "lint":
        return lint_main(args)
    if args.command == "telemetry":
        try:
            return telemetry_main(args)
        except ValueError as e:
            # usage mistakes (missing --chrome-out, no dump at the
            # default path) get the argparse-style message the other
            # subcommands use, not a Python traceback
            parser.error(str(e))
    if args.command == "gen":
        files = generate_project(args.input, args.response, args.output_dir,
                                 id_col=args.id_col, name=args.name,
                                 problem=args.problem, sparse=args.sparse,
                                 num_buckets=args.num_buckets)
        for fname, path in sorted(files.items()):
            print(f"wrote {path}")
        print(f"next: python {files['app.py']} train")
        return 0
    if args.command == "run":
        # env (not plumbing) so generated apps of any vintage pick these
        # up without a template change
        if args.profile:
            os.environ["TM_WORKFLOW_PROFILE"] = "1"
        if args.executor:
            os.environ["TM_WORKFLOW_EXECUTOR"] = args.executor
        if args.checkpoint_dir:
            os.environ["TM_TRAIN_CKPT"] = os.path.abspath(
                args.checkpoint_dir)
        if args.resume:
            if not args.checkpoint_dir \
                    and not os.environ.get("TM_TRAIN_CKPT"):
                parser.error("--resume needs --checkpoint-dir (or "
                             "TM_TRAIN_CKPT)")
            from .resilience.checkpoint import TOKEN_FILE
            ckpt = os.environ["TM_TRAIN_CKPT"]
            if not os.path.exists(os.path.join(ckpt, TOKEN_FILE)):
                parser.error(f"--resume: no train checkpoint under "
                             f"{ckpt} ({TOKEN_FILE} missing) — wrong "
                             f"checkpoint dir?")
        if args.faults:
            from .resilience import faults as _faults
            # configure parses (failing fast on a typo) AND arms this
            # process; the env var covers any child processes
            _faults.configure(args.faults)
            os.environ["TM_FAULTS"] = args.faults
        app = _import_project_app(os.path.dirname(
            os.path.abspath(args.params)))
        # TM_TRACE_DIR: capture a torch.profiler (Perfetto-readable)
        # device trace of the whole run alongside the span traces the
        # same knob + TM_TRACE_SAMPLE records
        from .profiling import trace as _device_trace
        with _device_trace(os.environ.get("TM_TRACE_DIR")):
            # apps generated before --device take two arguments
            app.main(args.run_type, args.params,
                     **({"device": args.device} if args.device else {}))
        return 0
    if args.command == "serve":
        if args.continuum_project and not args.engine:
            parser.error("--continuum-project requires --engine (the "
                         "continuum loop taps the request plane)")
        from .profiling import trace as _device_trace
        with _device_trace(os.environ.get("TM_TRACE_DIR")):
            if args.engine:
                serve_engine(args.model, args.input, args.output,
                             clients=args.clients,
                             max_wait_ms=args.max_wait_ms,
                             max_batch_rows=args.max_batch_rows,
                             deadline_ms=args.deadline_ms,
                             buckets=args.buckets,
                             stats_json=args.stats_json,
                             replicas=args.replicas,
                             continuum_project=args.continuum_project,
                             device=args.device)
                return 0
            serve_stream(args.model, args.input, args.output,
                         chunk_rows=args.chunk_rows, buckets=args.buckets,
                         buffer_size=args.buffer_size,
                         stats_json=args.stats_json, device=args.device)
        return 0
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
