"""Stage (de)serialization to JSON (the port's copy of
``transmogrifai_tpu/stages/persistence.py``).

Reference: core/.../stages/{OpPipelineStageReaderWriter, OpStageReader/
Writer}.scala — every stage persists as JSON: class name, uid, params,
input transient features, output feature name/type. Fitted model arrays are
serialized inline (small tabular models) as nested lists with dtype tags.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..features import types as ft
from ..features.feature import Feature, TransientFeature
from .base import PipelineStage, resolve_stage_class, stage_class_key


def encode_value(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return {"__ndarray__": v.tolist(), "dtype": str(v.dtype),
                "shape": list(v.shape)}
    if isinstance(v, (np.floating, np.integer, np.bool_)):
        return v.item()
    if isinstance(v, dict):
        return {k: encode_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [encode_value(x) for x in v]
    if isinstance(v, type) and issubclass(v, ft.FeatureType):
        return {"__ftype__": v.__name__}
    from ..features.manifest import ColumnManifest
    if isinstance(v, ColumnManifest):
        return {"__manifest__": v.to_json()}
    return v


def decode_value(v: Any) -> Any:
    if isinstance(v, dict):
        if "__ndarray__" in v:
            arr = np.array(v["__ndarray__"], dtype=v["dtype"])
            return arr.reshape(v["shape"])
        if "__ftype__" in v:
            return ft.FeatureTypeFactory.by_name(v["__ftype__"])
        if "__manifest__" in v:
            from ..features.manifest import ColumnManifest
            return ColumnManifest.from_json(v["__manifest__"])
        return {k: decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [decode_value(x) for x in v]
    return v


def stage_to_json(stage: PipelineStage) -> Dict[str, Any]:
    out_f = stage._output
    d: Dict[str, Any] = {
        "className": stage_class_key(type(stage)),
        "uid": stage.uid,
        "params": encode_value(stage.stage_params_json()),
        "inputs": [f.to_json() for f in stage.inputs],
    }
    if out_f is not None:
        d["output"] = {"name": out_f.name, "type": out_f.wtype.__name__,
                       "isResponse": out_f.is_response, "uid": out_f.uid}
    extra = getattr(stage, "extra_state_json", None)
    if extra is not None:
        d["extraState"] = encode_value(extra())
    return d


def stage_from_json(d: Dict[str, Any]) -> PipelineStage:
    if not isinstance(d, dict) or "className" not in d or "uid" not in d:
        # loaders of artifacts/checkpoints hit this on a structurally
        # broken document (hand-edited or written by a non-atomic
        # path); a bare KeyError would hide WHAT was corrupt
        raise ValueError(
            f"corrupt stage document: expected a dict with "
            f"className/uid, got {type(d).__name__} with keys "
            f"{sorted(d) if isinstance(d, dict) else d!r} — the "
            f"artifact was not written by stage_to_json")
    cls = resolve_stage_class(d["className"])
    params = decode_value(d.get("params", {}))
    if hasattr(cls, "from_params_json"):
        stage = cls.from_params_json(d["uid"], params)
    else:
        stage = cls(uid=d["uid"], **params)
    stage.inputs = tuple(TransientFeature.from_json(f) for f in d.get("inputs", []))
    out = d.get("output")
    if out is not None:
        parents = tuple(Feature(f.name, f.wtype, None, (), f.is_response, f.uid)
                        for f in stage.inputs)
        stage._output = Feature(out["name"], ft.FeatureTypeFactory.by_name(out["type"]),
                                stage, parents, out["isResponse"], out["uid"])
    extra = d.get("extraState")
    if extra is not None and hasattr(stage, "load_extra_state"):
        stage.load_extra_state(decode_value(extra))
    return stage
