"""Durable layer-level checkpoint/resume for ``Workflow.train`` (the port's copy of
``transmogrifai_tpu/resilience/checkpoint.py``).

The reference got mid-train failure recovery from Spark lineage: a lost
executor recomputes its partitions, a lost driver restarts the fit from
persisted stage state. A jax_graft train is one host process — a
SIGKILL (preempted TPU VM, OOM reaper) used to discard every fitted
stage. With ``Workflow.train(checkpoint_dir=...)`` (or ``TM_TRAIN_CKPT``):

* after each completed DAG layer the executor persists that layer's
  FITTED stage state (stages.persistence.stage_to_json — the same
  serialization ``WorkflowModel.save`` trusts) plus the layer's
  summaries and any degrade records, through the atomic write helper
  (resilience.atomic: tmp + fsync + rename, so a crash mid-save never
  leaves a parseable-but-torn layer file);
* a killed train restarted with the SAME arguments resumes at the
  first unfinished layer: completed layers' models load from JSON and
  only their (cheap, deterministic) transforms re-run to rebuild the
  dataset — fits, the expensive part, are never repeated. Fitted
  models, ``train_summaries``, and scores come out bitwise/JSON
  identical to an uninterrupted train (stage JSON round-trips are
  exact: float lists round-trip by shortest-repr, arrays carry dtype);
* the checkpoint carries a FINGERPRINT token (same drift-rejection
  idea as ``io.stream._load_stream_checkpoint``'s ``checkpoint_token``)
  over the layered plan (class/uid/params/wiring per stage), the raw
  feature schema, and a content digest of the training data. A
  checkpoint written under ANY other configuration — changed
  hyperparameters, different data, a reordered DAG — is rejected
  loudly with instructions, never silently resumed;
* checkpoints are deleted on successful completion, so the next train
  in the same dir starts fresh.

Layout::

    <checkpoint_dir>/
      train_token.json      {"format": 1, "token": sha256, "layers": N}
      layer_0000.json       {"stages": [...], "summaries": [...],
                             "degraded": [...]}
      stage_<uid>/          scratch for stages doing their own
                            intra-fit checkpointing (ModelSelector
                            family-level progress, streaming refits)
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import atomic

FORMAT = 1
TOKEN_FILE = "train_token.json"


class CheckpointMismatch(ValueError):
    """The checkpoint on disk was written under a different train
    configuration or data — resuming it would be silent corruption."""


def _json_default(o):
    """The ONE numpy-aware JSON encoder (workflow._json_default) —
    lazily resolved so this leaf module never imports the workflow
    machinery at import time."""
    from ..workflow import _json_default as wf_default
    return wf_default(o)


def _stable_repr(v) -> str:
    """Deterministic repr across PROCESSES: set/frozenset and dict
    iteration order depends on hash randomization, so a plain repr of
    a set-valued cell would fingerprint differently in the resumed
    process and wrongly reject a perfectly valid checkpoint. Recurses
    through containers — the hazard hides at any nesting depth."""
    if isinstance(v, (set, frozenset)):
        return "{" + ",".join(sorted(_stable_repr(x) for x in v)) + "}"
    if isinstance(v, dict):
        return "{" + ",".join(
            f"{_stable_repr(k)}:{_stable_repr(x)}"
            for k, x in sorted(v.items(),
                               key=lambda kv: _stable_repr(kv[0]))
        ) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_stable_repr(x) for x in v) + "]"
    return repr(v)


def _digest_column(col, full: bool = False) -> str:
    """Cheap, deterministic content digest of one training column.

    Numeric arrays hash their raw bytes — EXACT: any value change
    changes the token. Object columns (text, maps, lists) hash a
    strided ~128-cell sample of canonicalized cells plus the length by
    default: per-cell canonicalization is Python-level, and the sample
    cap is what keeps checkpoint overhead inside the <5% budget. An
    edit confined to unsampled object cells can therefore slip past
    the default token — set ``TM_CKPT_DIGEST=full`` (`full=True`) to
    hash EVERY object cell when that guarantee matters more than the
    overhead."""
    h = hashlib.sha256()
    arr = np.asarray(col)
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    if arr.dtype != object:
        h.update(arr.tobytes())
    else:
        n = arr.shape[0]
        idx = (range(n) if full or n <= 128
               else range(0, n, max(1, n // 128)))
        for i in idx:
            v = arr[i]
            if type(v) is str:
                h.update(v.encode())
                continue
            try:
                # JSON-able cells (map columns: str-keyed dicts of
                # floats/strs/bools) ride json's C encoder; sort_keys
                # gives the hash-order stability _stable_repr exists for
                h.update(json.dumps(v, sort_keys=True,
                                    ensure_ascii=False).encode())
            except (TypeError, ValueError):
                h.update(_stable_repr(v).encode())
    return h.hexdigest()


def train_fingerprint(raw_features: Sequence, layers: Sequence[Sequence],
                      ds) -> str:
    """The drift-rejection token: layered plan + schema + data digest.

    Everything that determines the fitted result is in here; anything
    NOT in here (executor mode, worker count, profiling flags) is
    guaranteed result-identical by the executor's own contract.
    Numeric columns, schema, and length are hashed exactly; object
    columns are sampled by default (``TM_CKPT_DIGEST=full`` hashes
    every cell — see _digest_column)."""
    from ..stages.base import stage_class_key
    from ..stages.persistence import encode_value

    full = os.environ.get("TM_CKPT_DIGEST", "").lower() == "full"
    doc: Dict[str, Any] = {
        "format": FORMAT,
        "raw": [[f.name, f.wtype.__name__, bool(f.is_response)]
                for f in raw_features],
        "plan": [[{
            "class": stage_class_key(type(st)),
            "uid": st.uid,
            "params": encode_value(st.stage_params_json()),
            "inputs": list(st.input_names),
            "output": [st.output.name, st.output.wtype.__name__],
        } for st in layer] for layer in layers],
        "rows": int(ds.n_rows),
        "columns": {n: _digest_column(ds.column(n), full=full)
                    for n in sorted(ds.column_names)},
    }
    blob = json.dumps(doc, sort_keys=True, default=_json_default)
    return hashlib.sha256(blob.encode()).hexdigest()


def resolve_checkpoint_dir(explicit: Optional[str] = None) -> Optional[str]:
    """checkpoint_dir argument, else the TM_TRAIN_CKPT env var."""
    return explicit or os.environ.get("TM_TRAIN_CKPT") or None


class TrainCheckpoint:
    """One train's durable progress. Built by :meth:`open`."""

    def __init__(self, dir_path: str, token: str, n_layers: int):
        self.dir = dir_path
        self.token = token
        self.n_layers = int(n_layers)
        self._resumable: Dict[int, Dict[str, Any]] = {}

    # -- lifecycle --------------------------------------------------------
    @classmethod
    def open(cls, dir_path: str, token: str, n_layers: int,
             require_resume: bool = False) -> "TrainCheckpoint":
        """Create-or-resume. An existing checkpoint with a mismatched
        token/plan is rejected loudly (CheckpointMismatch); with
        ``require_resume`` a MISSING checkpoint is also an error —
        guarding a deliberate resume against a typo'd dir silently
        starting the train over."""
        os.makedirs(dir_path, exist_ok=True)
        ck = cls(dir_path, token, n_layers)
        tok_path = os.path.join(dir_path, TOKEN_FILE)
        if os.path.exists(tok_path):
            try:
                with open(tok_path) as f:
                    doc = json.load(f)
            except ValueError as e:
                raise CheckpointMismatch(
                    f"train checkpoint {tok_path} is unreadable "
                    f"(truncated write? {e}) — delete the checkpoint "
                    f"dir to start over") from e
            if doc.get("format") != FORMAT:
                raise CheckpointMismatch(
                    f"train checkpoint {tok_path} has format "
                    f"{doc.get('format')!r}, expected {FORMAT} — delete "
                    f"the checkpoint dir to start over")
            if doc.get("token") != token or doc.get("layers") != n_layers:
                raise CheckpointMismatch(
                    f"train checkpoint in {dir_path} was written under a "
                    f"DIFFERENT configuration or data (token/plan "
                    f"mismatch) — it will not be resumed; delete the "
                    f"checkpoint dir (or point checkpoint_dir elsewhere) "
                    f"to train from scratch")
            ck._load_layers()
        else:
            if require_resume:
                raise CheckpointMismatch(
                    f"--resume requested but {dir_path} holds no train "
                    f"checkpoint ({TOKEN_FILE} missing) — wrong "
                    f"checkpoint dir?")
            atomic.atomic_write_json(
                tok_path, {"format": FORMAT, "token": token,
                           "layers": n_layers})
        return ck

    def _layer_path(self, li: int) -> str:
        return os.path.join(self.dir, f"layer_{li:04d}.json")

    def _load_layers(self) -> None:
        for li in range(self.n_layers):
            path = self._layer_path(li)
            if not os.path.exists(path):
                break               # first unfinished layer: resume here
            try:
                with open(path) as f:
                    self._resumable[li] = json.load(f)
            except ValueError as e:
                raise CheckpointMismatch(
                    f"train checkpoint layer file {path} is corrupt "
                    f"({e}) — delete the checkpoint dir to start over"
                ) from e

    # -- per-layer API (called from executor's merge loop) ----------------
    @property
    def resume_layers(self) -> int:
        """Number of leading layers restorable from this checkpoint."""
        return len(self._resumable)

    def restore_layer(self, li: int, layer: Sequence
                      ) -> Optional[Tuple[List, List[Tuple[str, Any]],
                                          List[Dict[str, Any]]]]:
        """(fitted models, summaries, degrade records) for a completed
        layer, or None when layer ``li`` must fit live. The saved stage
        uids are cross-checked against the live plan — a mismatch means
        the fingerprint failed to capture some drift, and resuming
        would mis-wire models."""
        doc = self._resumable.get(li)
        if doc is None:
            return None
        from ..stages.persistence import stage_from_json
        degraded = list(doc.get("degraded") or [])
        models = [stage_from_json(d) for d in doc["stages"]]
        want = [st.uid for st in layer]
        # fitted estimator models carry the estimator uid + "_model"
        # (stages.base.Estimator._make_model) — compare on the base uid
        got = [(u[:-len("_model")] if str(u).endswith("_model") else u)
               for u in (d.get("uid") for d in doc["stages"])]
        skipped = {r.get("uid") for r in degraded}
        if [u for u in want if u not in skipped] != got:
            raise CheckpointMismatch(
                f"train checkpoint layer {li} holds stages {got} but the "
                f"current plan expects {want} — configuration drift the "
                f"token did not cover; delete the checkpoint dir")
        summaries = [tuple(s) for s in doc.get("summaries") or []]
        return models, summaries, degraded

    def save_layer(self, li: int, models: Sequence,
                   summaries: Sequence[Tuple[str, Any]],
                   degraded: Sequence[Dict[str, Any]] = ()) -> None:
        from ..stages.persistence import stage_to_json
        doc = {
            "layer": li,
            "stages": [stage_to_json(m) for m in models],
            "summaries": [list(s) for s in summaries],
            "degraded": list(degraded),
        }
        # indent=None: indented encoding falls off json's C encoder
        # (~20x slower) and a layer file is machine-read only — this is
        # most of the checkpoint-overhead budget on wide layers
        atomic.atomic_write_json(self._layer_path(li), doc,
                                 default=_json_default, indent=None)
        # the layer is durable: per-stage scratch (selector family
        # progress, streaming refits) below it is now redundant
        for m in models:
            base = m.uid[:-len("_model")] if m.uid.endswith("_model") \
                else m.uid
            self.discard_stage_dir(base)

    # -- per-stage scratch (ModelSelector family progress etc.) -----------
    def stage_dir(self, uid: str) -> str:
        path = os.path.join(self.dir, f"stage_{uid}")
        os.makedirs(path, exist_ok=True)
        return path

    def discard_stage_dir(self, uid: str) -> None:
        shutil.rmtree(os.path.join(self.dir, f"stage_{uid}"),
                      ignore_errors=True)

    # -- completion -------------------------------------------------------
    def finish(self) -> None:
        """The train completed: delete every checkpoint file (and the
        dir itself when nothing foreign is left) so the next train
        starts fresh instead of resuming stale state."""
        for li in range(self.n_layers):
            path = self._layer_path(li)
            if os.path.exists(path):
                os.remove(path)
        tok = os.path.join(self.dir, TOKEN_FILE)
        if os.path.exists(tok):
            os.remove(tok)
        for entry in os.listdir(self.dir):
            if entry.startswith("stage_"):
                shutil.rmtree(os.path.join(self.dir, entry),
                              ignore_errors=True)
        try:
            os.rmdir(self.dir)      # only if empty: never delete a dir
        except OSError:             # the user put other files in
            pass
