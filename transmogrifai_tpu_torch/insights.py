"""ModelInsights + RecordInsightsLOCO: global and per-record explanations (the port's copy of
``transmogrifai_tpu/insights.py``).

Reference: core/src/main/scala/com/salesforce/op/ModelInsights.scala
(ModelInsights, FeatureInsights, Insights) and core/.../stages/impl/
insights/RecordInsightsLOCO.scala. The reference maps model coefficients/
importances back through OpVectorMetadata to raw features and merges
SanityChecker statistics and the ModelSelector validation grid into one
JSON report; LOCO scores each record with one feature group left out and
reports top-K score deltas.

LOCO in the port: the model family's torch predict runs on the model's
device over the masked copies of the record batch, a chunk of feature
groups at a time (the JAX package vmaps one predict over every group
mask). The report itself is host-side, built from the fitted stages,
the manifest and the checker summary. ``SparseRecordInsightsLOCO``
waits for ``models/sparse.py`` and raises "not ported".
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .dataset import Dataset
from .features import types as ft
from .features.feature import Feature
from .features.manifest import ColumnManifest
from .models.base import PredictionModel, params_to_numpy
from .stages.base import BinaryTransformer, UnaryTransformer, not_ported


# ---------------------------------------------------------------------------
# Contribution extraction (coefficients / importances per vector slot)
# ---------------------------------------------------------------------------

def model_contributions(model: PredictionModel) -> Optional[np.ndarray]:
    """Per-column contribution vector(s) for a fitted model.

    Returns (d,) for single-output models or (k, d) for multiclass;
    None when the family exposes no linear/importance structure.
    """
    p = params_to_numpy(model.model_params)
    if "beta" in p:                      # binary logistic / SVC / ridge
        return np.asarray(p["beta"])[:-1]            # drop intercept
    if "theta" in p:                     # softmax: (d+1, k)
        return np.asarray(p["theta"])[:-1].T
    if "feature_importance" in p:        # tree ensembles
        return np.asarray(p["feature_importance"])
    if "mean" in p and "var" in p:       # gaussian NB: standardized class
        mean = np.asarray(p["mean"])     # separation per column, (k, d)
        var = np.asarray(p["var"])
        pooled_sd = np.sqrt(np.maximum(var.mean(axis=0), 1e-12))
        return (mean - mean.mean(axis=0, keepdims=True)) / pooled_sd
    if "net" in p and "tok_w" in p.get("net", {}):
        # FT-Transformer: per-feature tokenizer weight norm. Inputs are
        # standardized inside the kernel, so the norm of feature j's
        # affine token map is its first-order sensitivity scale — the
        # data-free analog of |coefficient| (per-record attribution
        # stays LOCO's job).
        return np.linalg.norm(np.asarray(p["net"]["tok_w"]), axis=1)
    return None


def _contribution_per_column(contrib: Optional[np.ndarray], d: int
                             ) -> List[List[float]]:
    """Normalize to a per-column list of per-class contributions."""
    if contrib is None:
        return [[] for _ in range(d)]
    c = np.atleast_2d(np.asarray(contrib, dtype=np.float64))
    if c.shape[1] != d and c.shape[0] == d:
        c = c.T
    if c.shape[1] != d:
        return [[] for _ in range(d)]
    return [[float(v) for v in c[:, i]] for i in range(d)]


# ---------------------------------------------------------------------------
# ModelInsights
# ---------------------------------------------------------------------------

def model_insights(workflow_model, feature: Optional[Feature] = None
                   ) -> Dict[str, Any]:
    """Build the ModelInsights report for a fitted workflow.

    Mirrors the reference report shape: label summary, per-raw-feature
    derived-feature insights (contribution + sanity stats), selected-model
    validation grid, and per-stage info.
    """
    pred_model = _find_prediction_model(workflow_model, feature)
    manifest, sanity = _find_manifest_and_sanity(workflow_model, pred_model)

    label_name = next((f.name for f in workflow_model.raw_features
                       if f.is_response), None)

    stats = (sanity or {}).get("stats", {})
    names = (sanity or {}).get("names", [])
    dropped = (sanity or {}).get("dropped", {})
    cramers = (sanity or {}).get("cramersV", {})

    features_out: List[Dict[str, Any]] = []
    if manifest is not None:
        d = len(manifest)
        contrib = _contribution_per_column(
            model_contributions(pred_model) if pred_model else None, d)
        # index of full (pre-sanity) stats by column name
        stat_by_name: Dict[str, Dict[str, float]] = {}
        for j, nm in enumerate(names):
            stat_by_name[nm] = {k: stats[k][j] for k in stats if j < len(stats[k])}

        by_parent: Dict[str, List[Dict[str, Any]]] = {}
        for col in manifest:
            nm = col.column_name()
            st = stat_by_name.get(nm, {})
            entry = {
                "derivedFeatureName": nm,
                "derivedFeatureGroup": col.grouping,
                "derivedFeatureValue": col.indicator_value or col.descriptor_value,
                "contribution": contrib[col.index],
                "variance": st.get("variance"),
                "mean": st.get("mean"),
                "min": st.get("min"),
                "max": st.get("max"),
                "corr": st.get("corr_label"),
                "cramersV": cramers.get(col.feature_group()),
                "excluded": False,
            }
            by_parent.setdefault(col.parent_feature, []).append(entry)
        # sanity-dropped columns appear as excluded derived features
        kept_names = {c.column_name() for c in manifest}
        dropped_parents = (sanity or {}).get("droppedParents", {})
        raw_names = sorted((f.name for f in workflow_model.raw_features),
                           key=len, reverse=True)
        for nm, why in dropped.items():
            if nm in kept_names:
                continue
            parent = dropped_parents.get(nm) or next(
                (r for r in raw_names if nm == r or nm.startswith(r + "_")), nm)
            by_parent.setdefault(parent, []).append({
                "derivedFeatureName": nm, "excluded": True,
                "exclusionReason": why,
                "contribution": [],
                **{k: stat_by_name.get(nm, {}).get(s) for k, s in
                   (("variance", "variance"), ("mean", "mean"),
                    ("corr", "corr_label"))},
            })
        raw_types = {f.name: f.wtype.__name__
                     for f in workflow_model.raw_features}
        for parent, derived in sorted(by_parent.items()):
            features_out.append({
                "featureName": parent,
                "featureType": raw_types.get(parent, "OPVector"),
                "derivedFeatures": derived,
            })

    selected = dict(getattr(pred_model, "summary", {}) or {})
    family = (pred_model.params.get("family") if pred_model else None) \
        or selected.get("bestModel", {}).get("family")
    doc = {
        "label": {
            "labelName": label_name,
            "rawFeatureName": [label_name] if label_name else [],
        },
        "features": features_out,
        "selectedModelInfo": selected,
        "trainingParams": {
            "modelFamily": family,
            "problem": (pred_model.params.get("problem")
                        if pred_model else None)
            or (selected.get("problem") if selected else None),
        },
        "stageInfo": {
            st.uid: {"operation": st.operation_name,
                     "output": st.output.name,
                     "params": _safe_params(st)}
            for st in workflow_model.stages
        },
    }
    if sanity:
        # group-level checker stats (reference: SanityCheckerSummary in
        # ModelInsights) — per-column cramersV already rides each
        # derived-feature row; the group view adds PMI and drop counts
        doc["sanityCheckerSummary"] = {
            "cramersV": sanity.get("cramersV", {}),
            "pointwiseMutualInformation":
                sanity.get("pointwiseMutualInformation", {}),
            "dropped": sanity.get("dropped", {}),
            "featuresIn": sanity.get("featuresIn"),
            "featuresOut": sanity.get("featuresOut"),
        }
    sensitive = _sensitive_feature_information(workflow_model)
    if sensitive:
        doc["sensitiveFeatureInformation"] = sensitive
    lint_findings = (workflow_model.train_summaries or {}).get(
        "lintFindings")
    if lint_findings:
        # the opcheck pre-flight ran at train time (TM_LINT=warn|strict):
        # keep what was found — and possibly waived — visible in the
        # model's insight report
        doc["lintFindings"] = lint_findings
    degraded = (workflow_model.train_summaries or {}).get("degraded")
    if degraded:
        # the train completed in DEGRADED mode: stages skipped after
        # exhausted retries (resilience.policy). Anyone reading this
        # model's insights must see which features it trained without.
        doc["degradedStages"] = degraded
    return doc


def _sensitive_feature_information(wm) -> List[Dict[str, Any]]:
    """Reference 0.7 parity: ModelInsights reports every column-level
    sensitive verdict recorded at fit — SmartTextVectorizer's
    sensitive mode (ops/vectorizers.py) and HumanNameDetector
    (ops/sensitive.py)."""
    out: List[Dict[str, Any]] = []
    for st in wm.stages:
        p = getattr(st, "params", {})
        sens = p.get("sensitive")
        if sens:
            out.append({
                "featureName": st.input_names[0],
                "detector": "HumanName",
                "pctName": sens.get("pct_name"),
                "isName": sens.get("is_name"),
                "actionTaken": ("removed" if p.get("mode") == "removed"
                                else "detected"),
            })
        elif "is_name_column" in p:       # HumanNameDetector.Model
            out.append({
                "featureName": st.input_names[0],
                "detector": "HumanName",
                "pctName": p.get("pct_name"),
                "isName": p.get("is_name_column"),
                "actionTaken": "detected",
            })
    return out


def _safe_params(stage) -> Dict[str, Any]:
    out = {}
    for k, v in stage.params.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = repr(type(v).__name__)
    return out


def _find_prediction_model(wm, feature: Optional[Feature]):
    if feature is not None:
        st = wm.stage_by_output(feature.name)
        return st if isinstance(st, PredictionModel) else None
    for st in reversed(wm.stages):
        if isinstance(st, PredictionModel):
            return st
    # sparse selected models: Prediction-typed output carrying the
    # ModelSelectorSummary-shaped `summary` (models/sparse.py) — the
    # insights report covers the Criteo front door too
    for st in reversed(wm.stages):
        out = getattr(st, "output", None)
        if (out is not None and issubclass(out.wtype, ft.Prediction)
                and getattr(st, "summary", None)):
            return st
    return None


def _find_manifest_and_sanity(wm, pred_model
                              ) -> Tuple[Optional[ColumnManifest],
                                         Optional[Dict[str, Any]]]:
    """Locate the feature-vector manifest feeding the model and the
    SanityChecker summary (if one ran upstream)."""
    manifest = None
    sanity = None
    vec_name = None
    if pred_model is not None and len(pred_model.input_names) >= 2:
        # the feature VECTOR is the last input: (label, vector) for
        # dense models, (label, indices, vector) for sparse — using a
        # fixed slot would point sparse models at the SparseIndices
        # column and silently drop the dense manifest
        vec_name = pred_model.input_names[-1]
    def _stage_manifest(st):
        m = getattr(st, "manifest", None)
        if callable(m):  # vectorizer models expose manifest() methods
            try:
                m = m()
            except Exception:
                m = None
        return m if isinstance(m, ColumnManifest) else None

    for st in wm.stages:
        m = _stage_manifest(st)
        if m is not None and (vec_name is None or st.output.name == vec_name):
            manifest = m
        if st.operation_name == "sanityChecked" and getattr(st, "summary", None):
            sanity = st.summary
    return manifest, sanity


# ---------------------------------------------------------------------------
# RecordInsightsLOCO
# ---------------------------------------------------------------------------

#: masked feature values one LOCO predict call holds (64 Mi f32: 256 MiB)
LOCO_CHUNK_ELEMENTS = 1 << 26


class RecordInsightsLOCO(UnaryTransformer):
    """Per-record leave-one-feature-group-out explanation.

    Input: the OPVector feature the model consumes; output: a TextMap of
    the top-K feature groups by |score delta|, each value a JSON array of
    per-class deltas. Reference: RecordInsightsLOCO.scala.
    """
    in_type = ft.OPVector
    out_type = ft.TextMap
    operation_name = "loco"

    def __init__(self, model: Optional[PredictionModel] = None, top_k: int = 20,
                 uid=None, **kw):
        super().__init__(uid=uid, top_k=top_k, **kw)
        self.model = model
        self._groups: Optional[List[Tuple[str, List[int]]]] = None

    # persistence: store the wrapped model inline
    def extra_state_json(self):
        from .stages.persistence import stage_to_json
        return {"model_stage": stage_to_json(self.model) if self.model else None}

    def load_extra_state(self, d):
        from .stages.persistence import stage_from_json
        ms = d.get("model_stage")
        self.model = stage_from_json(ms) if ms else None

    def to(self, device) -> "RecordInsightsLOCO":
        if self.model is not None:
            self.model.to(device)
        return super().to(device)

    def _deltas(self, X: np.ndarray, masks: np.ndarray) -> np.ndarray:
        """(G, n, k) score deltas: the family's predict on the model's
        device, unmasked minus each group's masked copy, as many groups
        per predict call as fit in ``LOCO_CHUNK_ELEMENTS`` masked
        values."""
        fam = self.model.family
        n_classes = self.model.params["n_classes"]
        params = self.model.model_params
        dev = self.model.device
        n, d = X.shape
        Xt = torch.as_tensor(X, device=dev)
        keep = 1.0 - torch.as_tensor(masks, device=dev)           # (G, d)
        out = []
        with torch.inference_mode():
            base = fam.predict_kernel(params, Xt, n_classes)      # (n, k)
            step = max(1, LOCO_CHUNK_ELEMENTS // max(1, n * d))
            for g0 in range(0, keep.shape[0], step):
                kc = keep[g0:g0 + step]                           # (c, d)
                Xm = (Xt[None, :, :] * kc[:, None, :]).reshape(-1, d)
                probs = fam.predict_kernel(params, Xm, n_classes)
                out.append(base[None] - probs.reshape(kc.shape[0], n, -1))
            if not out:
                return np.zeros((0, n, base.shape[1]), np.float32)
            return torch.cat(out, dim=0).cpu().numpy()

    def _group_masks(self, ds: Dataset, d: int
                     ) -> Tuple[List[str], np.ndarray]:
        manifest = ds.manifest(self.input_names[0])
        if manifest is not None and len(manifest) == d:
            groups = sorted(manifest.groups().items())
            # display key: "parent" or "parent_grouping"
            keys = [g.rstrip("|").replace("|", "_") for g, _ in groups]
        else:
            groups = [(f"col_{i}", [i]) for i in range(d)]
            keys = [g for g, _ in groups]
        masks = np.zeros((len(groups), d), dtype=np.float32)
        for gi, (_, idxs) in enumerate(groups):
            masks[gi, np.asarray(idxs, dtype=int)] = 1.0
        return keys, masks

    def _transform_columns(self, ds: Dataset):
        if self.model is None:
            raise RuntimeError("RecordInsightsLOCO needs a fitted model")
        X = ds.column(self.input_names[0]).astype(np.float32)
        n, d = X.shape
        keys, masks = self._group_masks(ds, d)
        deltas = self._deltas(X, masks)                           # (G, n, k)
        deltas = np.moveaxis(deltas, 0, 1)                        # (n, G, k)
        score = np.abs(deltas).max(axis=2)                        # (n, G)
        top_k = min(int(self.params["top_k"]), len(keys))
        out = np.empty(n, dtype=object)
        for i in range(n):
            order = np.argsort(-score[i])[:top_k]
            out[i] = {keys[g]: json.dumps(
                [round(float(v), 6) for v in deltas[i, g]]) for g in order}
        return out, ft.TextMap, None

    def transform_value(self, vec: ft.OPVector):
        ds = Dataset({self.input_names[0]:
                      np.asarray([list(vec.value)], dtype=np.float32)},
                     {self.input_names[0]: ft.OPVector})
        col, _, _ = self._transform_columns(ds)
        return ft.TextMap(col[0])


class SparseRecordInsightsLOCO(BinaryTransformer):
    """Per-record leave-one-FIELD-out explanation for the hashed sparse
    path: it scores the sparse model families of ``models/sparse.py``,
    which are not ported yet (ROADMAP queue 1, item 6)."""
    in_types = (ft.SparseIndices, ft.OPVector)
    out_type = ft.TextMap
    operation_name = "sparseLoco"

    def __init__(self, *args, **kw):
        raise not_ported("SparseRecordInsightsLOCO", "models.sparse")
