"""Load a portable artifact into the port's device stage chain.

The JAX package exports fitted workflows as a portable artifact
(``transmogrifai_tpu.portable_export.export_portable``):

    manifest.json   device-chain IR: ops, wiring, scalars
    params.npz      every fitted array, flat "prefix/path" keys
    _SUCCESS        completeness sentinel, written last

That format needs no JAX, so it is how weights carry across:
:func:`load` reads an artifact directory and :func:`from_portable`
turns the manifest and its numpy arrays into the port's stages, with
every parameter a tensor on the scoring device.

Like the numpy runtime every artifact carries (``portable_runtime.py``,
whose format constant and ``params.npz`` pytree helpers this module
shares; its ``score_columns``), the port scores an artifact from its
manifest's ``boundary`` columns: a
non-empty ``hostPrefix`` (text pivots, hashing run on the host before
the device chain) is metadata, and the caller supplies those stages'
outputs. Integer boundary columns (hashed bucket ids) stay integer:
the scorer sends them to the card as int32 for the gathers, never
through f32. Ops: impute, concat, keep_cols, predict and the hashed
``sparse_predict`` / ``sparse_softmax`` (``models/sparse.py``). A
predict stage may name any family of ``MODEL_FAMILIES`` (every linear
and tree family and the FT-Transformer, whose recorded ``nHeads`` must
be the family's); a family the port does not know raises naming it. Parameter pytrees keep their lists (the FT-Transformer's
``layers``) through ``params.npz``'s integer path parts.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ._device import resolve_device
from .models.base import MODEL_FAMILIES, PredictionModel, params_from_numpy
from .models.sparse import SparseLogisticModel, SparseSoftmaxModel
from .ops.sanity_checker import SanityCheckerModel
from .ops.vectorizers import RealVectorizerModel, VectorsCombiner
# flatten_tree is re-exported: the exporter and callers flatten here
from .portable_runtime import FORMAT_VERSION, flatten_tree, unflatten_tree
from .resilience import atomic

#: the portable ops the port runs on the device
SUPPORTED_OPS = ("impute", "concat", "keep_cols", "predict",
                 "sparse_predict", "sparse_softmax")


# ---------------------------------------------------------------------------
# the stage chain
# ---------------------------------------------------------------------------

class PortableModel:
    """A portable artifact's device chain on one device: the fitted
    stages in order, the boundary (raw input) columns, which of them
    are response columns (absent at scoring time -> zero placeholders),
    the result column names and the exported serving buckets. Keeps the
    manifest and numpy arrays so :meth:`to` can rebuild it elsewhere."""

    def __init__(self, manifest: Dict[str, Any],
                 arrays: Dict[str, Dict[str, Any]], stages: List,
                 device: torch.device):
        self.manifest = manifest
        self.arrays = arrays
        self.stages = stages
        self.device = device
        self.boundary: List[str] = list(manifest["boundary"])
        self.response_boundary = set(manifest["responseBoundary"])
        self.result_names: List[str] = list(manifest["resultNames"])
        sb = manifest.get("scoreBuckets")
        self.score_buckets = tuple(int(b) for b in sb) if sb else None
        self._host = None

    def score_columns(self, columns: Dict[str, Sequence]
                      ) -> Dict[str, np.ndarray]:
        """{boundary column: array} -> {result name: (n, k) f32 numpy
        array} on the host, the JAX package's ``score_columns``: the
        artifact's own numpy runtime (``portable_runtime``) over this
        chain's manifest and arrays. Response boundary columns may be
        omitted (zero placeholders)."""
        if self._host is None:
            from .portable_runtime import PortableModel as HostModel
            self._host = HostModel(self.manifest, self.arrays)
        return self._host.score_columns(columns)

    def to(self, device) -> "PortableModel":
        """The same chain with every parameter on ``device``."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        return from_portable(self.manifest, self.arrays, dev)

    def compile_scoring(self, buckets=None, device=None):
        """A :class:`workflow.FusedScorer` over this chain (see there)."""
        from .workflow import FusedScorer
        return FusedScorer(self, buckets=buckets, device=device)


def _build_stage(i: int, st: Dict[str, Any], arrs: Dict[str, Any],
                 device: torch.device):
    op = st.get("op")
    ins: Sequence[str] = st["inputs"]
    out = st["out"]
    if op == "impute":
        return RealVectorizerModel(fill_value=st["fill"],
                                   track_nulls=st["track"]).wire(ins, out)
    if op == "concat":
        return VectorsCombiner().wire(ins, out)
    if op == "keep_cols":
        keep = np.asarray(arrs["keep"], np.int64).tolist()
        return SanityCheckerModel(keep_indices=keep).wire(ins, out)
    if op == "predict":
        family = st["family"]
        if family not in MODEL_FAMILIES:
            raise ValueError(
                f"portable stage {i} ({out!r}): model family {family!r} "
                f"is not ported (have {sorted(MODEL_FAMILIES)})")
        heads = getattr(MODEL_FAMILIES[family], "n_heads", None)
        if "nHeads" in st and int(st["nHeads"]) != heads:
            raise ValueError(
                f"portable stage {i} ({out!r}): {family} artifact with "
                f"nHeads={st['nHeads']}, the port's family runs {heads}")
        params = params_from_numpy(arrs.get("params", {}), device)
        return PredictionModel(ins, out, family=family,
                               n_classes=int(st["nClasses"]),
                               model_params=params)
    if op in ("sparse_predict", "sparse_softmax"):
        # inputs: (label?, idx, Xnum); the label is a response placeholder
        cls = SparseLogisticModel if op == "sparse_predict" \
            else SparseSoftmaxModel
        return cls(model_params=params_from_numpy(
            arrs.get("params", {}), device)).wire(ins, out)
    raise ValueError(
        f"portable stage {i} ({out!r}): op {op!r} is not ported (have "
        f"{list(SUPPORTED_OPS)})")


def from_portable(manifest: Dict[str, Any],
                  arrays: Dict[str, Dict[str, Any]],
                  device=None) -> PortableModel:
    """Carry the JAX package's exported parameters across: a portable
    ``manifest`` (the parsed manifest.json) and ``arrays`` (per-stage
    numpy pytrees keyed by stage index as a string, as :func:`load`
    reads them from params.npz) -> a :class:`PortableModel` whose
    parameters are tensors on ``device`` (None: CUDA, raising without
    it). The ``hostPrefix`` is metadata, as in the JAX runtime: the
    chain scores its boundary columns. Raises ValueError naming any op
    or model family the port does not have."""
    if manifest.get("format") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported portable format {manifest.get('format')!r}")
    dev = resolve_device(device)
    stages = [_build_stage(i, st, arrays.get(str(i), {}), dev)
              for i, st in enumerate(manifest["stages"])]
    return PortableModel(manifest, arrays, stages, dev)


def load(artifact_dir: str, device=None) -> PortableModel:
    """Read a portable artifact directory (manifest.json + params.npz,
    stamped complete by its ``_SUCCESS`` sentinel) onto ``device``
    (None: CUDA, raising without it)."""
    atomic.require_complete(artifact_dir, "portable artifact")
    with open(os.path.join(artifact_dir, "manifest.json")) as f:
        manifest = json.load(f)
    flat = dict(np.load(os.path.join(artifact_dir, "params.npz"),
                        allow_pickle=False))
    per_stage: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in flat.items():
        sid, rest = key.split("/", 1)
        per_stage.setdefault(sid, {})[rest] = val
    arrays = {sid: unflatten_tree(d) for sid, d in per_stage.items()}
    return from_portable(manifest, arrays, device)
