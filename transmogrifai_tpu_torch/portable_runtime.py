"""Portable scoring runtime: numpy-only, zero package dependencies.

The port's own copy of the JAX package's numpy interpreter
(``transmogrifai_tpu/portable.py``), so an artifact the port exports
serves where neither torch nor jax is installed (the MLeap analog;
reference: local/ + MLeap runtime — serving without a SparkSession).
``WorkflowModel.export_portable(dir)`` writes an artifact directory:

    manifest.json        device-chain IR: ops, wiring, scalars
    params.npz           every fitted array, flat "prefix/path" keys
    portable_runtime.py  THIS FILE, copied verbatim

and a service loads it with nothing but numpy installed:

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "portable_runtime", f"{artifact}/portable_runtime.py")
    rt = importlib.util.module_from_spec(spec); spec.loader.exec_module(rt)
    model = rt.load(artifact)
    scores = model.score_columns({"x0": np.array([...]), ...})

This module MUST import only the stdlib and numpy — it is the whole
serving runtime. It interprets the fused device chain
(workflow.FusedScorer's op vocabulary): impute, concat, keep_cols,
per-family model predicts and the hashed sparse heads, reproducing the
device functions' values in f32. The port's loader
(``transmogrifai_tpu_torch.portable``) reads the same two files onto a
device.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Sequence

import numpy as np

FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# params.npz pytree flattening
# ---------------------------------------------------------------------------

def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict/list/scalar/array pytree -> {"a/b/0/c": array} leaves."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten_tree(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Any:
    """Inverse of flatten_tree. Integer path components become lists."""
    if list(flat.keys()) == [""]:
        return flat[""]
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[k]) for k in sorted(node, key=int)]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


# ---------------------------------------------------------------------------
# numpy kernels mirroring the device fns (f32 semantics)
# ---------------------------------------------------------------------------

def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _softmax(x, axis=-1):
    z = x - np.max(x, axis=axis, keepdims=True)
    e = np.exp(z)
    return e / np.sum(e, axis=axis, keepdims=True)


def _add_intercept(X):
    return np.concatenate(
        [X, np.ones((X.shape[0], 1), X.dtype)], axis=1)


def op_impute(col, fill: float, track: bool):
    col = np.asarray(col, np.float32)
    isnull = np.isnan(col)
    if track:
        # hand-rolled 2-column assembly: np.stack's dispatcher +
        # issubdtype checks dominated the portable per-row profile;
        # measured 140us -> 102us/row on a 12-feature model. Serving
        # latency is this runtime's whole reason to be
        out = np.empty((col.shape[0], 2), np.float32)
        np.copyto(out[:, 0], col)
        if isnull.any():
            out[:, 0][isnull] = np.float32(fill)
        out[:, 1] = isnull
        return out
    filled = np.where(isnull, np.float32(fill), col)
    return filled[:, None]


def op_concat(*blocks):
    return np.concatenate([np.asarray(b, np.float32) for b in blocks],
                          axis=1)


def op_keep_cols(vec, keep):
    return np.asarray(vec)[:, keep.astype(np.int64)].astype(np.float32)


# -- model family predicts ---------------------------------------------------

def _predict_linear(params, X, n_classes):
    if n_classes == 2:
        p1 = _sigmoid(_add_intercept(X) @ params["beta"])
        return np.stack([1.0 - p1, p1], axis=1)
    return _softmax(_add_intercept(X) @ params["theta"], axis=1)


def _predict_linear_reg(params, X, n_classes):
    return (_add_intercept(X) @ params["beta"])[:, None]


def _predict_svc(params, X, n_classes):
    p1 = _sigmoid(_add_intercept(X) @ params["beta"])
    return np.stack([1.0 - p1, p1], axis=1)


def _predict_gnb(params, X, n_classes):
    mean, var = params["mean"], params["var"]
    ll = -0.5 * np.sum(
        (X[:, None, :] - mean[None]) ** 2 / var[None] + np.log(var)[None],
        axis=2) + params["logprior"][None]
    return _softmax(ll, axis=1)


def _predict_glm(params, X, n_classes):
    eta = _add_intercept(X) @ params["beta"]
    if float(params["familyLink"]) > 0.5:
        return np.exp(np.clip(eta, -30.0, 30.0))[:, None]
    return eta[:, None]


def _predict_tree_one(feat, thr, leaf, X):
    """Level-order perfect-binary-tree routing (trees.predict_tree)."""
    D = leaf.shape[0].bit_length() - 1
    pos = np.zeros(X.shape[0], np.int64)
    for level in range(D):
        idx = (1 << level) - 1 + pos
        f = feat[idx].astype(np.int64)
        t = thr[idx]
        x = np.take_along_axis(X, f[:, None], 1)[:, 0]
        pos = 2 * pos + (x > t).astype(np.int64)
    return leaf[pos]


def _ensemble_raw(params, X):
    X = np.asarray(X, np.float32)
    preds = np.stack([_predict_tree_one(f, t, l, X)
                      for f, t, l in zip(params["feat"], params["thr"],
                                         params["leaf"])])     # (T, n, C)
    out = np.einsum("tnc,t->nc", preds, params["tree_w"])
    if "base" in params:
        out = out + params["base"][None, :]
    return out


def _probs_from_mean(mean, n_classes):
    p = np.clip(mean, 0.0, None)
    s = np.sum(p, axis=1, keepdims=True)
    return np.where(s > 1e-9, p / np.maximum(s, 1e-9),
                    np.full_like(p, 1.0 / n_classes))


def _predict_tree_cls(params, X, n_classes):
    return _probs_from_mean(_ensemble_raw(params, X), n_classes)


def _predict_tree_reg(params, X, n_classes):
    return _ensemble_raw(params, X)


def _predict_boosted_cls(params, X, n_classes):
    raw = _ensemble_raw(params, X)
    if raw.shape[1] == 1:
        p1 = _sigmoid(raw[:, 0])
        return np.stack([1.0 - p1, p1], axis=1)
    return _softmax(raw, axis=1)


def _layer_norm(x, ln):
    mu = np.mean(x, axis=-1, keepdims=True)
    var = np.var(x, axis=-1, keepdims=True)
    return (x - mu) / np.sqrt(var + 1e-5) * ln["g"] + ln["b"]


def _mha(x, lp, n_heads):
    n, T, D = x.shape
    Dh = D // n_heads

    def heads(a):
        return a.reshape(n, T, n_heads, Dh).transpose(0, 2, 1, 3)

    q, k, v = heads(x @ lp["wq"]), heads(x @ lp["wk"]), heads(x @ lp["wv"])
    att = np.einsum("nhtd,nhsd->nhts", q, k) / np.sqrt(np.float32(Dh))
    att = _softmax(att, axis=-1)
    out = np.einsum("nhts,nhsd->nhtd", att, v)
    return out.transpose(0, 2, 1, 3).reshape(n, T, D) @ lp["wo"]


def _gelu(x):
    # tanh approximation — the FT-Transformer's GELU
    return 0.5 * x * (1.0 + np.tanh(
        np.sqrt(2.0 / np.pi) * (x + 0.044715 * x ** 3)))


def _ft_forward(net, X, n_heads):
    n = X.shape[0]
    tokens = X[:, :, None] * net["tok_w"][None] + net["tok_b"][None]
    cls = np.broadcast_to(net["cls"], (n, 1, net["cls"].shape[0]))
    h = np.concatenate([cls, tokens], axis=1)
    for lp in net["layers"]:
        h = h + _mha(_layer_norm(h, lp["ln1"]), lp, n_heads)
        ff = _gelu(_layer_norm(h, lp["ln2"]) @ lp["ff1"] + lp["ff1_b"])
        h = h + ff @ lp["ff2"] + lp["ff2_b"]
    z = _layer_norm(h[:, 0], net["final_ln"])
    return z @ net["head_w"] + net["head_b"]


def _predict_ft(params, X, n_classes, n_heads=4, **_):
    Xs = (np.asarray(X, np.float32) - params["mu"]) / params["sd"]
    out = _ft_forward(params["net"], Xs, n_heads)
    if out.shape[1] == 1:
        return out
    return _softmax(out, axis=-1)


_FAMILY_PREDICT = {
    "LogisticRegression": _predict_linear,
    "LinearRegression": _predict_linear_reg,
    "LinearSVC": _predict_svc,
    "NaiveBayes": _predict_gnb,
    "GeneralizedLinearRegression": _predict_glm,
    "DecisionTreeClassifier": _predict_tree_cls,
    "RandomForestClassifier": _predict_tree_cls,
    "DecisionTreeRegressor": _predict_tree_reg,
    "RandomForestRegressor": _predict_tree_reg,
    "GBTClassifier": _predict_boosted_cls,
    "XGBoostClassifier": _predict_boosted_cls,
    "GBTRegressor": _predict_tree_reg,
    "XGBoostRegressor": _predict_tree_reg,
    "FTTransformerClassifier": _predict_ft,
    "FTTransformerRegressor": _predict_ft,
}


def _sparse_linear_z(idx, Xnum, params):
    """Shared linear logit of every hashed sparse family: gathered table
    sum + dense matvec + bias (idx placeholder-cast to int when a float
    column arrives; small ids only on that path)."""
    idx = np.asarray(idx)
    if not np.issubdtype(idx.dtype, np.integer):
        idx = idx.astype(np.int64)
    Xnum = np.asarray(Xnum, np.float32)
    z = (params["table"][idx].sum(axis=1)
         + Xnum @ params["dense"] + params["bias"])
    return idx, z


def op_sparse_predict(idx, Xnum, params):
    """Hashed sparse predict (LR / FTRL weights / FM — the numpy mirror
    of models/sparse.py's family-agnostic predict), plus the FM
    interaction term when an "emb" table is present."""
    idx, z = _sparse_linear_z(idx, Xnum, params)
    if "emb" in params:
        e = params["emb"][idx]                        # (n, K, k)
        s = e.sum(axis=1)                             # (n, k)
        z = z + 0.5 * (s * s - (e * e).sum(axis=1)).sum(axis=1)
    p1 = 1.0 / (1.0 + np.exp(-np.clip(z, -60.0, 60.0)))
    return np.stack([1.0 - p1, p1], axis=1).astype(np.float32)


def op_sparse_softmax(idx, Xnum, params):
    """Multiclass hashed softmax: per-class table gather-sum + dense
    matvec, softmax over classes (numpy mirror of sparse_softmax_logits)."""
    _, z = _sparse_linear_z(idx, Xnum, params)             # (n, C)
    z = z - z.max(axis=1, keepdims=True)
    e = np.exp(z)
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def op_predict(X, params, family: str, n_classes: int, **kw):
    if family not in _FAMILY_PREDICT:
        raise ValueError(f"portable runtime has no predictor for "
                         f"family {family!r}")
    return np.asarray(
        _FAMILY_PREDICT[family](params, np.asarray(X, np.float32),
                                int(n_classes), **kw), np.float32)


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------

class PortableModel:
    """Scores the exported device chain from boundary numeric columns."""

    def __init__(self, manifest: Dict[str, Any],
                 arrays: Dict[str, Dict[str, Any]]):
        if manifest.get("format") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported portable format {manifest.get('format')!r}")
        self.manifest = manifest
        self.arrays = arrays
        self.boundary: List[str] = manifest["boundary"]
        self.response_boundary = set(manifest["responseBoundary"])
        self.result_names: List[str] = manifest["resultNames"]
        # serving bucket set the exporter was configured with (None when
        # absent — older artifacts load unchanged). Metadata only here:
        # the numpy interpreter handles any row count without recompiles
        sb = manifest.get("scoreBuckets")
        self.score_buckets = tuple(int(b) for b in sb) if sb else None

    def score_columns(self, columns: Dict[str, Sequence]
                      ) -> Dict[str, np.ndarray]:
        """{boundary column: array} -> {result name: (n, k) f32 array}.
        Response-typed boundary inputs may be omitted (zero placeholders,
        exactly like fused scoring of label-free rows)."""
        n = first = None
        for k, v in columns.items():
            m = len(np.asarray(v))
            if n is None:
                n, first = m, k
            elif m != n:   # fail at the API boundary, not deep in ops
                raise ValueError(
                    f"boundary column {k!r} has {m} rows but {first!r} "
                    f"has {n}; all supplied columns must share one length")
        if n is None:
            raise ValueError("score_columns needs at least one column")
        cols: Dict[str, np.ndarray] = {}
        for name in self.boundary:
            if name in columns:
                a = np.asarray(columns[name])
                # integer boundary columns (hashed sparse indices) keep
                # integer dtype — casting through f32 would corrupt
                # bucket ids above 2^24, and narrowing to int32 would
                # wrap ids >= 2^31; everything else scores as f32.
                # Already-normalized arrays pass through WITHOUT a copy
                # (astype always copies), so a serving layer that
                # pre-normalizes — serving/registry._PortableBackend —
                # does not pay the conversion twice per request
                dt = (np.int64 if np.issubdtype(a.dtype, np.integer)
                      else np.float32)
                cols[name] = a if a.dtype == dt else a.astype(dt)
            elif name in self.response_boundary:
                cols[name] = np.zeros((n,), np.float32)
            else:
                raise ValueError(f"boundary input {name!r} missing")
        for i, st in enumerate(self.manifest["stages"]):
            ins = [cols[m] for m in st["inputs"]]
            arrs = self.arrays.get(str(i), {})
            op = st["op"]
            if op == "impute":
                out = op_impute(ins[-1], st["fill"], st["track"])
            elif op == "concat":
                out = op_concat(*ins)
            elif op == "keep_cols":
                out = op_keep_cols(ins[-1], arrs["keep"])
            elif op == "predict":
                kw = {"n_heads": st["nHeads"]} if "nHeads" in st else {}
                out = op_predict(ins[-1], arrs.get("params", {}),
                                 st["family"], st["nClasses"], **kw)
            elif op == "sparse_predict":
                # inputs: (label?, idx, Xnum) — label is a response
                # placeholder; idx is the int index matrix
                out = op_sparse_predict(ins[-2], ins[-1],
                                        arrs.get("params", {}))
            elif op == "sparse_softmax":
                out = op_sparse_softmax(ins[-2], ins[-1],
                                        arrs.get("params", {}))
            else:
                raise ValueError(f"unknown portable op {op!r}")
            cols[st["out"]] = out
        return {name: cols[name] for name in self.result_names}


def load(artifact_dir: str) -> PortableModel:
    # completeness sentinel (written LAST by the atomic exporter;
    # literal name here because this file is the COPIED no-dependency
    # runtime — it must match resilience.atomic.SENTINEL): a dir
    # without it is a save that crashed mid-write, and loading it
    # could serve a torn model
    if not os.path.exists(os.path.join(artifact_dir, "_SUCCESS")):
        raise ValueError(
            f"{artifact_dir}: portable artifact has no _SUCCESS "
            f"completeness sentinel — the export did not finish "
            f"(crashed mid-write?); re-export the artifact")
    with open(os.path.join(artifact_dir, "manifest.json")) as f:
        manifest = json.load(f)
    flat = dict(np.load(os.path.join(artifact_dir, "params.npz"),
                        allow_pickle=False))
    per_stage: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in flat.items():
        sid, rest = key.split("/", 1)
        per_stage.setdefault(sid, {})[rest] = val
    arrays = {sid: unflatten_tree(d) for sid, d in per_stage.items()}
    return PortableModel(manifest, arrays)
