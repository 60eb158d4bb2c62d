"""opcheck layer 1: typed-DAG verification over the lazy feature graph (the port's copy of
``transmogrifai_tpu/lint/graph.py``).

Everything here runs on the UNFITTED workflow — no data, no fit, no jit.
The walk is independent of workflow.compute_dag (which raises on the
defects this module is meant to report) and is cycle-safe: a cyclic DAG
yields a TM-LINT-002 finding instead of blowing the stack.

Checks:
  * TM-LINT-001 — declared ``in_types``/``in_type`` conformance along
    every edge, including variadic sequence and binary-sequence stages
    (the runtime skips this for LambdaTransformer and for manually
    constructed Features; the linter does not).
  * TM-LINT-002 — cycles.
  * TM-LINT-003/004 — duplicate stage uids / output column names (the
    same defects compute_dag hard-errors on at construction; reported
    here so `lint` can diagnose a DAG built outside Workflow).
  * TM-LINT-005 — response-leakage reachability: the response (or a
    feature derived from it) feeding a predictor path. A response in
    the FIRST input slot of a multi-input stage is a declared
    supervision edge (SanityChecker, model selectors) and is exempt;
    everything else taints its consumers.
  * TM-LINT-006 — declared features that never reach a result feature.
  * TM-LINT-009 — retrace hazards: a ``device_fn_signature`` that
    varies across identical calls (or is unhashable) defeats the
    executor's fused-block cache and the persistent compile cache —
    every train re-traces (PERFORMANCE.md §6).

Export-skew checks (TM-LINT-007/008) verify a portable-export manifest
against itself and, when available, against the fitted model's terminal
outputs — the serving/training skew gate used by ModelRegistry before a
version can publish.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set

from ..features import types as ft
from ..features.feature import Feature
from .diagnostics import Diagnostic

_FIX = {
    "type": "change the upstream feature type or the stage's declared "
            "in_types so the edge type-checks",
    "cycle": "break the parent cycle; a feature cannot be its own "
             "ancestor",
    "uid": "give each stage a unique uid (or stop re-wiring one stage "
           "object with set_input twice)",
    "name": "rename one output (make_output_name) so dataset columns "
            "cannot collide",
    "leak": "remove the response from the predictor path; supervised "
            "stages take the label as their FIRST input alongside the "
            "features",
    "dead": "add the feature to result_features or wire it into a "
            "downstream stage",
    "sig": "return the same hashable tuple from device_fn_signature for "
           "identical configs (derive it from params, never from object "
           "identity)",
    "degrade": "route the degradable output through a variadic combiner "
               "(which shrinks when a stage degrades) or change the "
               "stage's failure_policy back to 'fail'",
}


class GraphIndex:
    """Cycle-safe closure over a result-feature set."""

    def __init__(self):
        self.features: Dict[str, Feature] = {}     # uid -> Feature
        self.topo: List[Feature] = []              # parents before children
        self.cycles: List[List[str]] = []          # feature-name paths


def build_index(result_features: Sequence[Feature]) -> GraphIndex:
    idx = GraphIndex()
    WHITE, GREY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}

    for root in result_features:
        # iterative DFS: (feature, child-iterator) stack, postorder topo
        stack = [(root, iter(root.parents))]
        if color.get(root.uid, WHITE) != WHITE:
            continue
        color[root.uid] = GREY
        idx.features[root.uid] = root
        while stack:
            feat, children = stack[-1]
            child = next(children, None)
            if child is None:
                stack.pop()
                color[feat.uid] = BLACK
                idx.topo.append(feat)
                continue
            c = color.get(child.uid, WHITE)
            if c == GREY:
                # back edge: record the cycle path from the stack
                path = [f.name for f, _ in stack
                        if color.get(f.uid) == GREY]
                idx.cycles.append(path + [child.name])
            elif c == WHITE:
                color[child.uid] = GREY
                idx.features[child.uid] = child
                stack.append((child, iter(child.parents)))
    return idx


# ---------------------------------------------------------------------------
# Per-check passes
# ---------------------------------------------------------------------------

def _expected_input_types(stage, n: int):
    """Declared per-slot FeatureType bases for a stage with n inputs, or
    (None, arity_error_message)."""
    from ..stages.base import (BinarySequenceEstimator,
                               BinarySequenceTransformer,
                               SequenceEstimator, SequenceTransformer)
    if isinstance(stage, (BinarySequenceTransformer,
                          BinarySequenceEstimator)):
        if n < 1:
            return None, "needs at least its fixed first input"
        return [stage.in_type1] + [stage.in_type] * (n - 1), None
    if isinstance(stage, (SequenceTransformer, SequenceEstimator)):
        return [stage.in_type] * n, None
    declared = tuple(getattr(stage, "in_types", ()) or ())
    if declared:
        if len(declared) != n:
            return None, (f"takes {len(declared)} inputs, wired with {n}")
        return list(declared), None
    in_type = getattr(stage, "in_type", None)
    if in_type is not None:
        return [in_type] * n, None
    return None, None           # no declaration: nothing to verify


def check_types(idx: GraphIndex) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    for f in idx.topo:
        st = f.origin_stage
        if f.is_raw or st is None or not f.parents:
            continue
        expected, arity_err = _expected_input_types(st, len(f.parents))
        if arity_err:
            out.append(Diagnostic(
                "TM-LINT-001",
                f"{type(st).__name__} {arity_err} "
                f"({[p.name for p in f.parents]})",
                stage_uid=st.uid, feature=f.name, fix_hint=_FIX["type"]))
            continue
        if expected is None:
            continue
        for i, (p, t) in enumerate(zip(f.parents, expected)):
            if not issubclass(p.wtype, t):
                out.append(Diagnostic(
                    "TM-LINT-001",
                    f"{type(st).__name__} input {i} ({p.name!r}): expected "
                    f"{t.__name__}, got {p.wtype.__name__}",
                    stage_uid=st.uid, feature=f.name,
                    fix_hint=_FIX["type"]))
    return out


def check_cycles(idx: GraphIndex) -> List[Diagnostic]:
    return [Diagnostic("TM-LINT-002",
                       "feature DAG cycle: " + " -> ".join(path),
                       feature=path[-1], fix_hint=_FIX["cycle"])
            for path in idx.cycles]


def duplicate_pairs(features) -> tuple:
    """The ONE duplicate-detection rule shared by the linter
    (TM-LINT-003/004) and workflow._check_dag_integrity's hard error.

    Returns ``(name_dups, stage_dups)``: name_dups is
    ``[(name, first_uid, second_uid), ...]`` for output-column
    collisions; stage_dups is ``[(stage_uid, first_feature_uid,
    second_feature_uid), ...]`` for duplicate stage uids / one stage
    wired twice."""
    name_dups: List[tuple] = []
    stage_dups: List[tuple] = []
    by_name: Dict[str, str] = {}
    by_stage_uid: Dict[str, str] = {}           # stage uid -> feature uid
    for f in features:
        prev = by_name.setdefault(f.name, f.uid)
        if prev != f.uid:
            name_dups.append((f.name, prev, f.uid))
        st = f.origin_stage
        if f.is_raw or st is None:
            continue
        prev_f = by_stage_uid.setdefault(st.uid, f.uid)
        if prev_f != f.uid:
            stage_dups.append((st.uid, prev_f, f.uid))
    return name_dups, stage_dups


def check_duplicates(idx: GraphIndex) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    name_dups, stage_dups = duplicate_pairs(idx.topo)
    for name, prev, uid in name_dups:
        out.append(Diagnostic(
            "TM-LINT-004",
            f"two features named {name!r} (uids {prev}, {uid}) — "
            f"the dataset column silently last-wins",
            feature=name, fix_hint=_FIX["name"]))
    for stage_uid, _, feat_uid in stage_dups:
        out.append(Diagnostic(
            "TM-LINT-003",
            f"stage uid {stage_uid!r} produces two distinct output "
            f"features — duplicate uid or one stage wired twice; "
            f"layer merge keeps only one",
            stage_uid=stage_uid, fix_hint=_FIX["uid"]))
    return out


def _is_label_slot(parents: Sequence[Feature], i: int) -> bool:
    """The declared supervision slot: a response feature in the FIRST
    input position of a multi-input stage (SanityChecker, the model
    selectors, the sparse model stages)."""
    return i == 0 and len(parents) >= 2 and parents[i].is_response


def _is_post_model_edge(parents: Sequence[Feature], i: int) -> bool:
    """A response consumed by a stage that also takes a Prediction-typed
    input sits DOWNSTREAM of a fit (PredictionDescaler referencing the
    scaled response): not a leak at this edge — but the output CARRIES
    response data, so the caller still taints it in case it re-enters a
    predictor path (a stacked second model)."""
    return parents[i].is_response and any(
        issubclass(q.wtype, ft.Prediction) for q in parents)


def check_leakage(idx: GraphIndex) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    tainted: Set[str] = set()       # feature uids carrying response data
    for f in idx.topo:              # parents before children
        st = f.origin_stage
        if f.is_raw or st is None:
            continue
        if f.is_response:
            # the OUTPUT is itself response-marked (label scaling /
            # indexing): the data stays on the response side, visibly —
            # downstream consumers of f face these same checks
            continue
        taint_out = False
        for i, p in enumerate(f.parents):
            if _is_label_slot(f.parents, i):
                continue            # declared label input: not a leak
            if _is_post_model_edge(f.parents, i):
                taint_out = True    # legit here, but the data travels on
                continue
            if p.is_response:
                taint_out = True
                out.append(Diagnostic(
                    "TM-LINT-005",
                    f"response {p.name!r} feeds {type(st).__name__} "
                    f"input {i} — a predictor path derived from the "
                    f"label leaks the response into training",
                    stage_uid=st.uid, feature=p.name,
                    fix_hint=_FIX["leak"]))
            elif p.uid in tainted:
                taint_out = True
                if issubclass(f.wtype, ft.Prediction):
                    # propagated response data reached a MODEL's feature
                    # slot — the stacked-model leak an origin-only
                    # report would miss
                    out.append(Diagnostic(
                        "TM-LINT-005",
                        f"feature {p.name!r} carries response-derived "
                        f"data into {type(st).__name__} input {i} — a "
                        f"downstream model trains on the label",
                        stage_uid=st.uid, feature=p.name,
                        fix_hint=_FIX["leak"]))
        if taint_out:
            tainted.add(f.uid)
    return out


def check_dead_features(idx: GraphIndex,
                        extra_features: Sequence[Feature]
                        ) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    for f in extra_features or ():
        if f.uid not in idx.features:
            out.append(Diagnostic(
                "TM-LINT-006",
                f"feature {f.name!r} ({f.uid}) never reaches any result "
                f"feature — no workflow stage will ever compute it",
                feature=f.name, fix_hint=_FIX["dead"]))
    return out


def check_retrace_hazards(idx: GraphIndex) -> List[Diagnostic]:
    from ..stages.base import Transformer
    out: List[Diagnostic] = []
    seen: Set[str] = set()
    for f in idx.topo:
        st = f.origin_stage
        if f.is_raw or st is None or st.uid in seen:
            continue
        seen.add(st.uid)
        if not isinstance(st, Transformer):
            continue                # estimators carry no device fn yet
        if type(st).make_device_fn is Transformer.make_device_fn:
            continue                # host-only stage: nothing to cache
        try:
            s1 = st.device_fn_signature()
            s2 = st.device_fn_signature()
        except Exception as e:      # noqa: BLE001 — user stage code
            out.append(Diagnostic(
                "TM-LINT-009",
                f"{type(st).__name__}.device_fn_signature raised "
                f"{type(e).__name__}: {e}",
                stage_uid=st.uid, fix_hint=_FIX["sig"]))
            continue
        if s1 is None and s2 is None:
            continue                # opted out of train-time fusion
        if s1 != s2:
            out.append(Diagnostic(
                "TM-LINT-009",
                f"{type(st).__name__}.device_fn_signature returns a "
                f"different value on every call ({s1!r} != {s2!r}) — "
                f"the jitted-block cache misses on every train and "
                f"compiled programs accumulate without bound",
                stage_uid=st.uid, fix_hint=_FIX["sig"]))
            continue
        try:
            hash(s1)
        except TypeError:
            out.append(Diagnostic(
                "TM-LINT-009",
                f"{type(st).__name__}.device_fn_signature is not "
                f"hashable ({s1!r}) — it cannot key the fused-block "
                f"cache",
                stage_uid=st.uid, fix_hint=_FIX["sig"]))
    return out


def check_degrade_safety(idx: GraphIndex) -> List[Diagnostic]:
    """TM-LINT-010: a ``failure_policy="degrade"`` stage whose output
    reaches the response/label slot or a model's feature vector
    NON-optionally.

    Degradation drops the stage's output and cascades through
    fixed-arity consumers (executor._apply_degradation uses the
    prune_layers rule) — only a VARIADIC consumer (sequence /
    binary-sequence tail) absorbs the loss by shrinking. So a
    degradable feature that can reach a label slot or a
    Prediction-producing stage through fixed-arity edges would, on
    degrade, silently change what the model trains on (or kill the
    train the policy promised to save). The walk propagates a
    "degradable" taint exactly along the edges the runtime cascade
    would remove."""
    from ..stages.base import (BinarySequenceEstimator,
                               BinarySequenceTransformer,
                               SequenceEstimator, SequenceTransformer)
    variadic_types = (SequenceTransformer, SequenceEstimator,
                      BinarySequenceTransformer, BinarySequenceEstimator)
    binseq_types = (BinarySequenceTransformer, BinarySequenceEstimator)
    out: List[Diagnostic] = []
    #: feature uid -> uid of the degrade-marked stage it would vanish with
    degradable: Dict[str, str] = {}
    for f in idx.topo:              # parents before children
        st = f.origin_stage
        if f.is_raw or st is None:
            continue
        src: Optional[str] = (
            st.uid if getattr(st, "failure_policy", "fail") == "degrade"
            else None)
        variadic = isinstance(st, variadic_types)
        for i, p in enumerate(f.parents):
            if p.uid not in degradable:
                continue
            origin = degradable[p.uid]
            # a variadic tail slot shrinks away cleanly; the FIXED head
            # of a binary-sequence stage does not
            absorbed = variadic and not (isinstance(st, binseq_types)
                                         and i == 0)
            if _is_label_slot(f.parents, i):
                out.append(Diagnostic(
                    "TM-LINT-010",
                    f"degradable output {p.name!r} (stage {origin}) "
                    f"feeds the supervision slot of "
                    f"{type(st).__name__} — degrading it would drop "
                    f"the label path",
                    stage_uid=origin, feature=p.name,
                    fix_hint=_FIX["degrade"]))
                continue
            if issubclass(f.wtype, ft.Prediction) and not absorbed:
                out.append(Diagnostic(
                    "TM-LINT-010",
                    f"degradable output {p.name!r} (stage {origin}) "
                    f"feeds {type(st).__name__} input {i} "
                    f"non-optionally — degrading it would silently "
                    f"change what the model trains on (route it "
                    f"through a variadic combiner instead)",
                    stage_uid=origin, feature=p.name,
                    fix_hint=_FIX["degrade"]))
                continue
            if not absorbed and src is None:
                src = origin        # the cascade would remove f too
        if src is not None:
            degradable[f.uid] = src
    return out


def analyze_graph(result_features: Sequence[Feature],
                  extra_features: Sequence[Feature] = ()
                  ) -> List[Diagnostic]:
    """Run every layer-1 check; order: structural errors first."""
    idx = build_index(result_features)
    findings: List[Diagnostic] = []
    findings += check_cycles(idx)
    findings += check_duplicates(idx)
    findings += check_types(idx)
    if not idx.cycles:              # taint needs a valid topo order
        findings += check_leakage(idx)
    findings += check_dead_features(idx, extra_features)
    findings += check_retrace_hazards(idx)
    if not idx.cycles:              # taint needs a valid topo order
        findings += check_degrade_safety(idx)
    return findings


# ---------------------------------------------------------------------------
# Serving/training skew: portable-export manifests (TM-LINT-007/008)
# ---------------------------------------------------------------------------

def check_export_manifest(manifest: Dict[str, Any],
                          result_names: Optional[Sequence[str]] = None
                          ) -> List[Diagnostic]:
    """Verify a portable-export ``manifest.json`` document.

    Internal consistency always runs: every stage's inputs must be
    satisfied by the boundary or an earlier stage's output, result
    columns must actually be produced, the response boundary must be a
    subset of the boundary, and ``scoreBuckets`` must be a normalized
    bucket set (the exact rule of ``workflow._normalize_buckets``).
    When ``result_names`` (the live model's terminal outputs) is given,
    the manifest's columns are cross-checked against it — the
    serving/training skew gate.
    """
    out: List[Diagnostic] = []
    loc = "manifest.json"
    boundary = list(manifest.get("boundary") or [])
    produced: Set[str] = set(boundary)
    outs_seen: Set[str] = set()
    for i, st in enumerate(manifest.get("stages") or []):
        name = st.get("out", f"<stage {i}>")
        missing = [n for n in st.get("inputs", []) if n not in produced]
        if missing:
            out.append(Diagnostic(
                "TM-LINT-007",
                f"manifest stage {i} ({name!r}) reads {missing} — not in "
                f"the boundary or any earlier stage output",
                location=loc, feature=name,
                fix_hint="re-export the artifact; the manifest stage "
                         "order must be topological over the boundary"))
        if name in outs_seen:
            out.append(Diagnostic(
                "TM-LINT-007",
                f"manifest produces output {name!r} twice",
                location=loc, feature=name,
                fix_hint="re-export; duplicate outputs overwrite each "
                         "other at scoring time"))
        outs_seen.add(name)
        produced.add(name)
    for n in manifest.get("responseBoundary") or []:
        if n not in boundary:
            out.append(Diagnostic(
                "TM-LINT-007",
                f"responseBoundary column {n!r} is not in the boundary",
                location=loc, feature=n,
                fix_hint="re-export the artifact from the fitted model"))
    declared_results = list(manifest.get("resultNames") or [])
    for n in declared_results:
        if n not in produced:
            out.append(Diagnostic(
                "TM-LINT-007",
                f"result column {n!r} is never produced by the manifest "
                f"stages",
                location=loc, feature=n,
                fix_hint="re-export the artifact from the fitted model"))
    if result_names is not None and set(declared_results) != set(result_names):
        out.append(Diagnostic(
            "TM-LINT-007",
            f"manifest result columns {sorted(declared_results)} != the "
            f"model's terminal outputs {sorted(result_names)} — scores "
            f"served from this artifact would not match training",
            location=loc,
            fix_hint="re-export the artifact from THIS model version"))
    if "scoreBuckets" in manifest:
        from ..workflow import _normalize_buckets
        raw = manifest["scoreBuckets"]
        try:
            norm = _normalize_buckets(tuple(raw))
        except (TypeError, ValueError) as e:
            out.append(Diagnostic(
                "TM-LINT-008",
                f"scoreBuckets {raw!r} is not a valid bucket set: {e}",
                location=loc,
                fix_hint="export with buckets=True or an ascending "
                         "tuple of positive ints"))
        else:
            if list(norm) != list(raw):
                out.append(Diagnostic(
                    "TM-LINT-008",
                    f"scoreBuckets {raw!r} is not normalized (expected "
                    f"{list(norm)}) — a loader would compile a "
                    f"different bucket universe than the exporter",
                    location=loc,
                    fix_hint="export with the normalized ascending "
                             "bucket tuple"))
    return out
