"""SanityChecker: automatic feature validation before modeling (the port's copy of
``transmogrifai_tpu/ops/sanity_checker.py``).

Reference: core/src/main/scala/com/salesforce/op/stages/impl/preparators/
SanityChecker.scala (SanityChecker, SanityCheckerSummary, CorrelationType,
ColumnStatistics) + DerivedFeatureFilterUtils. Given (label, features)
it computes column stats, label correlations (Pearson/Spearman),
feature-feature correlations and Cramér's V for categorical indicator
groups, applies leakage rules (maxRuleConfidence/minRequiredRuleSupport),
and drops offending columns.

In the port all statistics are one function of tensors on the
checker's device (:func:`statistics`): moments, Pearson against the
label, Spearman as Pearson over column ranks, and the d x d
feature-feature product; with a mesh of several ranks they run
row-sharded over it (``parallel.sharded_statistics``). The ranks follow
the JAX package's switch (:func:`host_ranks_enabled`): host ranks on
the CPU (:func:`host_rank_columns`), and on the card
:func:`rank_columns`, an average rank on the device with the same tie semantics (one stable sort
per column, first and last ordinal rank per run of equal values). The
contingency rows for Cramér's V are one ``cols.T @ y_onehot`` product
on one device (with a mesh too, as in the JAX package); Cramér's V, PMI
and the drop rules run on the host on the tiny per-column vectors.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..dataset import Dataset
from ..features import types as ft
from ..features.feature import Feature
from ..features.manifest import ColumnManifest
from ..stages.base import BinaryEstimator, BinaryTransformer


def rank_columns(x: torch.Tensor) -> torch.Tensor:
    """Column-wise AVERAGE ranks on the tensor's device: ties share the
    mean of their ordinal ranks (scipy.stats.rankdata(method='average')
    minus 1, mllib/commons-math Spearman semantics).

    ONE stable sort per column, then a forward cummax over run starts
    and a reverse cummin over run ends give each run's first/last
    ordinal rank; the averaged rank scatters back through the sort
    permutation. Every rank is an exact .0/.5 half (n < 2**23), so the
    result is bitwise equal to :func:`host_rank_columns`."""
    n, d = x.shape
    sv, order = torch.sort(x, dim=0, stable=True)
    idx = torch.arange(n, dtype=torch.float32, device=x.device)[:, None]
    idx = idx.expand(n, d)
    brk = sv[1:] != sv[:-1]
    ones = torch.ones((1, d), dtype=torch.bool, device=x.device)
    start = torch.cat([ones, brk], dim=0)
    end = torch.cat([brk, ones], dim=0)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=x.device)
    first = torch.cummax(torch.where(start, idx, -inf), dim=0).values
    last = torch.flip(torch.cummin(torch.flip(torch.where(end, idx, inf),
                                              [0]), dim=0).values, [0])
    avg = (first + last) * 0.5
    return torch.empty((n, d), dtype=torch.float32,
                       device=x.device).scatter_(0, order, avg)


def host_rank_columns(x: np.ndarray) -> np.ndarray:
    """Column-wise AVERAGE ranks on the host — value-identical to
    :func:`rank_columns` (exact .0/.5 halves in both), vectorized numpy:
    one stable argsort per column, run starts/ends found by
    adjacent-difference, forward cummax / reverse cummin give each run's
    first/last ordinal rank, and the average scatters back through the
    sort permutation."""
    nn, dd = x.shape
    order = np.argsort(x, axis=0, kind="stable")
    sv = np.take_along_axis(x, order, axis=0)
    idx = np.arange(nn, dtype=np.float64)[:, None]
    brk = sv[1:] != sv[:-1]
    start = np.vstack([np.ones((1, dd), bool), brk])
    end = np.vstack([brk, np.ones((1, dd), bool)])
    first = np.maximum.accumulate(np.where(start, idx, -np.inf), axis=0)
    last = np.minimum.accumulate(
        np.where(end, idx, np.inf)[::-1], axis=0)[::-1]
    avg = ((first + last) * 0.5).astype(np.float32)
    out = np.empty((nn, dd), np.float32)
    np.put_along_axis(out, order, avg, axis=0)
    return out


def statistics(xf: torch.Tensor, yf: torch.Tensor, rx: torch.Tensor,
               ry: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The statistics body on f32 tensors of one device: moments,
    correlations, Spearman over the supplied column ranks ``rx`` (n, d)
    and label ranks ``ry`` (n,), and the d x d feature-feature product
    (the JAX package's ``_stats_from_ranked``)."""
    n = xf.shape[0]
    mean = torch.mean(xf, dim=0)
    var = torch.clamp(torch.mean(xf * xf, dim=0) - mean * mean, min=0.0)
    std = torch.sqrt(var)
    mn = torch.amin(xf, dim=0)
    mx = torch.amax(xf, dim=0)
    y_mean = torch.mean(yf)
    y_std = torch.sqrt(torch.clamp(torch.mean(yf * yf) - y_mean ** 2,
                                   min=0.0))

    safe_std = torch.where(std > 0, std, torch.ones_like(std))
    xs = (xf - mean) / safe_std
    ys = (yf - y_mean) / torch.where(y_std > 0, y_std,
                                     torch.ones_like(y_std))
    corr_label = (xs.T @ ys) / n
    corr_label = torch.where(std > 0, corr_label,
                             torch.full_like(corr_label, float("nan")))

    # Spearman: Pearson over column ranks
    rx_m = rx - torch.mean(rx, dim=0)
    ry_m = ry - torch.mean(ry)
    rx_sd = torch.sqrt(torch.clamp(torch.mean(rx_m * rx_m, dim=0),
                                   min=1e-12))
    ry_sd = torch.sqrt(torch.clamp(torch.mean(ry_m * ry_m), min=1e-12))
    spearman = (rx_m.T @ ry_m) / (n * rx_sd * ry_sd)

    # feature-feature correlation (one d x d product)
    corr_ff = (xs.T @ xs) / n

    return dict(mean=mean, std=std, variance=var, min=mn, max=mx,
                corr_label=corr_label, spearman=spearman, corr_ff=corr_ff,
                y_mean=y_mean, y_std=y_std)


def host_ranks_enabled(device) -> bool:
    """TM_CHECKER_HOST_RANKS: 1 forces host ranks, 0 forces the device
    ranks, unset = auto (host on the CPU, the device elsewhere, as in
    the JAX package). The two paths are value-identical."""
    env = os.environ.get("TM_CHECKER_HOST_RANKS")
    if env is not None:
        return env != "0"
    return torch.device(device).type == "cpu"


def compute_statistics(x, y, device=None) -> Dict[str, np.ndarray]:
    """One-pass stats for the feature matrix ``x`` (n, d) and the label
    ``y`` (n,), numpy or tensors, on ``device`` (None: CUDA, raising
    without a card) -> host numpy arrays."""
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32) if not
                         isinstance(x, torch.Tensor) else x,
                         dtype=torch.float32).to(dev)
    yt = torch.as_tensor(np.asarray(y, np.float32) if not
                         isinstance(y, torch.Tensor) else y,
                         dtype=torch.float32).to(dev)
    with torch.inference_mode():
        if host_ranks_enabled(dev):
            x_np = xt.cpu().numpy()
            y_np = yt.cpu().numpy()
            rx = torch.from_numpy(host_rank_columns(x_np)).to(dev)
            ry = torch.from_numpy(
                host_rank_columns(y_np[:, None])[:, 0].copy()).to(dev)
        else:
            rx = rank_columns(xt)
            ry = rank_columns(yt[:, None])[:, 0]
        out = statistics(xt, yt, rx, ry)
        return {k: v.cpu().numpy() for k, v in out.items()}


def _cramers_from_table(t: np.ndarray) -> float:
    """Cramér's V (bias-uncorrected, as mllib) from a host-side (g, c)
    contingency table — tiny, pure numpy."""
    n = max(float(t.sum()), 1e-9)
    row = t.sum(axis=1, keepdims=True)
    col = t.sum(axis=0, keepdims=True)
    e = row @ col / n
    with np.errstate(invalid="ignore", divide="ignore"):
        chi2 = float(np.sum(np.where(e > 0, (t - e) ** 2 / np.maximum(e, 1e-9),
                                     0.0)))
    g, c = t.shape
    denom = n * max(min(g, c) - 1, 1)
    return float(np.sqrt(chi2 / denom))


def _pmi_from_table(t: np.ndarray) -> list:
    """Pointwise mutual information per (indicator value, label class)
    from a host-side contingency table — the reference's categorical
    stat alongside Cramér's V (SanityChecker.scala
    ColumnStatistics.pointwiseMutualInfo); log2, None for never-observed
    cells."""
    n_tot = max(float(t.sum()), 1e-9)
    pv = t.sum(axis=1, keepdims=True) / n_tot
    pc = t.sum(axis=0, keepdims=True) / n_tot
    with np.errstate(invalid="ignore", divide="ignore"):
        m = np.log2((t / n_tot) / np.maximum(pv * pc, 1e-300))
    m = np.where(t > 0, m, np.nan)
    return [[None if not np.isfinite(x) else round(float(x), 6)
             for x in row] for row in m]


def cramers_v(group_cols, y_onehot, device=None
              ) -> Tuple[float, np.ndarray]:
    """Cramér's V from indicator cols vs label.

    group_cols: (n, g) 0/1 indicators; y_onehot: (n, c).
    Returns (V, contingency table (g, c)). The fit path batches every
    group's contingency rows into ONE device product and applies
    `_cramers_from_table` host-side; this per-group entry point stays
    for direct use and tests.
    """
    dev = resolve_device(device)
    t = contingency(torch.as_tensor(np.asarray(group_cols, np.float32),
                                    device=dev),
                    torch.as_tensor(np.asarray(y_onehot, np.float32),
                                    device=dev)).cpu().numpy()
    return _cramers_from_table(t), t


def contingency(cols: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    """(n, D) indicator columns x (n, c) one-hot label -> (D, c)
    contingency rows for EVERY indicator column in one product (the
    JAX package's ``_contingency_kernel``, computed outside any Pallas
    kernel there too). Integer counts, exact in f32."""
    return torch.matmul(cols.T, y_onehot)


class SanityCheckerModel(BinaryTransformer):
    """Fitted column filter: keeps the surviving slots of the feature vector."""
    in_types = (ft.RealNN, ft.OPVector)
    out_type = ft.OPVector
    operation_name = "sanityChecked"

    def __init__(self, keep_indices: Sequence[int] = (),
                 manifest: Optional[ColumnManifest] = None,
                 summary: Optional[Dict[str, Any]] = None, uid=None, **kw):
        super().__init__(uid=uid, keep_indices=list(keep_indices), **kw)
        self.manifest = manifest
        self.summary = summary or {}

    def extra_state_json(self):
        return {"manifest": self.manifest, "summary": self.summary}

    def load_extra_state(self, d):
        self.manifest = d.get("manifest")
        self.summary = d.get("summary", {})

    def _transform_columns(self, ds: Dataset):
        vec_name = self.input_names[1]
        arr = ds.column(vec_name)
        keep = np.asarray(self.params["keep_indices"], dtype=int)
        return arr[:, keep].astype(np.float32), ft.OPVector, self.manifest

    def transform_value(self, label, vec: ft.OPVector):
        keep = self.params["keep_indices"]
        vals = vec.value
        return ft.OPVector(tuple(vals[i] for i in keep))

    def make_device_fn(self):
        keep_np = np.asarray(self.params["keep_indices"], dtype=np.int64)
        held = {}     # device -> the index tensor there (built once)

        def fn(label, vec):  # label unused at transform time
            keep = held.get(vec.device)
            if keep is None:
                keep = held[vec.device] = torch.as_tensor(
                    keep_np, device=vec.device)
            return vec.index_select(1, keep).to(torch.float32)

        return fn

    def portable_spec(self):
        return {"op": "keep_cols",
                "arrays": {"keep": np.asarray(self.params["keep_indices"],
                                              np.int32)}}


class SanityChecker(BinaryEstimator):
    """(label, features) -> cleaned features.

    Drop rules (mirroring the reference's semantics):
    - variance < min_variance                      -> "low variance"
    - |corr(label)| > max_correlation              -> "leakage: label correlation"
    - Cramér's V > max_cramers_v (indicator groups)-> "leakage: cramersV"
    - rule confidence >= max_rule_confidence with support >=
      min_required_rule_support (categorical vs binary label)
    - |corr(f_i, f_j)| > max_feature_corr          -> drop the later column
    """
    in_types = (ft.RealNN, ft.OPVector)
    out_type = ft.OPVector
    operation_name = "sanityChecked"
    model_cls = SanityCheckerModel

    def __init__(self, min_variance: float = 1e-5,
                 max_correlation: float = 0.95,
                 max_feature_corr: float = 0.999,
                 max_cramers_v: float = 0.95,
                 max_rule_confidence: float = 1.0,
                 min_required_rule_support: int = 1,
                 correlation_type: str = "pearson",
                 correlation_exclusion: str = "none",
                 remove_bad_features: bool = True,
                 mesh=None, uid=None, device=None, **kw):
        if correlation_exclusion not in ("none", "hashed_text"):
            raise ValueError(
                f"unknown correlation_exclusion {correlation_exclusion!r};"
                f" one of 'none', 'hashed_text'")
        super().__init__(
            uid=uid, min_variance=min_variance, max_correlation=max_correlation,
            max_feature_corr=max_feature_corr, max_cramers_v=max_cramers_v,
            max_rule_confidence=max_rule_confidence,
            min_required_rule_support=min_required_rule_support,
            correlation_type=correlation_type,
            correlation_exclusion=correlation_exclusion,
            remove_bad_features=remove_bad_features, **kw)
        #: optional mesh (``parallel.data_mesh``): with more than one
        #: rank the statistics run row-sharded over it. Transient, like
        #: ``device``: a fitted model carries results, never the mesh it
        #: was fit on
        self.mesh = mesh
        #: where the statistics run (transient, not persisted): None
        #: resolves to CUDA at fit time, raising without a card, or to
        #: the mesh's first device when there is a mesh
        self.device = device

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        label_name, vec_name = self.input_names
        x_np = ds.column(vec_name).astype(np.float32)
        y_np = ds.column(label_name).astype(np.float32)
        manifest = ds.manifest(vec_name)
        d = x_np.shape[1]
        if manifest is None:
            manifest = ColumnManifest.from_json(
                [{"parentFeature": vec_name, "parentType": "OPVector",
                  "descriptorValue": f"col_{i}", "grouping": None,
                  "indicatorValue": None, "index": i} for i in range(d)])

        mesh = self.mesh
        if mesh is None:
            # TM_MESH_AXIS=grid,data opts the statistics into row
            # sharding over the configured devices, as in the JAX
            # package; an explicit mesh wins
            from ..parallel.mesh import configured_devices, \
                resolve_mesh_config
            if resolve_mesh_config().axis == "grid,data":
                from ..parallel.data_parallel import data_mesh
                mesh = data_mesh(configured_devices())
        dev = (mesh.devices[0] if mesh is not None and self.device is None
               else resolve_device(self.device))
        x = torch.as_tensor(x_np, device=dev)
        if mesh is not None and mesh.size > 1:
            from ..parallel.data_parallel import sharded_statistics
            stats = sharded_statistics(x_np, y_np, mesh)
        else:
            stats = compute_statistics(x, y_np, dev)

        p = self.params
        reasons: Dict[int, str] = {}

        def drop(i: int, why: str):
            reasons.setdefault(int(i), why)

        # low variance
        for i in np.where(stats["variance"] < p["min_variance"])[0]:
            drop(i, "low variance")
        # correlation exclusion (reference: CorrelationExclusion.HashedText)
        # — hashing-trick slots carry spurious pairwise correlations at
        # CV-grid sample sizes; under 'hashed_text' they are exempt from
        # the CORRELATION drop rules (variance/Cramer's rules still apply)
        corr_exempt: set = set()
        if p.get("correlation_exclusion") == "hashed_text":
            corr_exempt = {i for i, c in enumerate(manifest)
                           if c.is_hashed}

        # label-correlation leakage
        corr = stats["corr_label"] if p["correlation_type"] == "pearson" \
            else stats["spearman"]
        for i in np.where(np.abs(np.nan_to_num(corr)) > p["max_correlation"])[0]:
            if i not in corr_exempt:
                drop(i, "label correlation too high")

        # Cramér's V + association rules on indicator groups vs binary label
        y_int = y_np.astype(np.int32)
        is_binary_label = set(np.unique(y_int)) <= {0, 1} and \
            np.allclose(y_np, y_int)
        cramers: Dict[str, float] = {}
        pmi: Dict[str, Dict[str, list]] = {}
        groups = manifest.indicator_groups() if is_binary_label else {}
        if groups:
            # ONE device product computes the contingency rows for every
            # indicator column of every group; V / rule confidence are
            # tiny host-side numpy per group
            all_idx = torch.as_tensor(
                np.asarray([i for idxs in groups.values() for i in idxs],
                           np.int64), device=dev)
            y_oh = torch.as_tensor(np.stack([1.0 - y_np, y_np], axis=1),
                                   dtype=torch.float32, device=dev)
            with torch.inference_mode():
                t_all = contingency(x.index_select(1, all_idx),
                                    y_oh).cpu().numpy()
            pos = 0
            for group, idxs in groups.items():
                table = t_all[pos:pos + len(idxs)]
                pos += len(idxs)
                v = _cramers_from_table(table)
                cramers[group] = v
                pmi[group] = {"labelValues": ["0", "1"],
                              "byIndicator": _pmi_from_table(table)}
                if v > p["max_cramers_v"]:
                    for i in idxs:
                        drop(i, "cramersV too high")
                # association rule confidence: P(y=1 | slot=1)
                support = table.sum(axis=1)
                with np.errstate(invalid="ignore", divide="ignore"):
                    conf = np.where(support > 0, table[:, 1] / np.maximum(support, 1), 0.0)
                for j, i in enumerate(idxs):
                    c = max(conf[j], 1.0 - conf[j])
                    if support[j] >= p["min_required_rule_support"] and \
                            c >= p["max_rule_confidence"]:
                        drop(i, "rule confidence too high (leakage)")

        # feature-feature correlation: drop the later of each offending pair
        ff = np.abs(np.nan_to_num(stats["corr_ff"]))
        np.fill_diagonal(ff, 0.0)
        hi, hj = np.where(np.triu(ff, 1) > p["max_feature_corr"])
        for i, j in zip(hi.tolist(), hj.tolist()):
            if i in corr_exempt or j in corr_exempt:
                continue
            if i not in reasons and j not in reasons:
                drop(j, f"correlated with column {i}")

        if not p["remove_bad_features"]:
            reasons = {}
        keep = [i for i in range(d) if i not in reasons]
        if not keep:  # never drop everything
            keep = list(range(d))
            reasons = {}

        names = manifest.column_names()
        summary = {
            "names": names,
            "stats": {k: stats[k].tolist() for k in
                      ("mean", "std", "variance", "min", "max",
                       "corr_label", "spearman")},
            "cramersV": cramers,
            "pointwiseMutualInformation": pmi,
            "dropped": {names[i]: why for i, why in sorted(reasons.items())},
            "droppedParents": {names[i]: manifest[i].parent_feature
                               for i in sorted(reasons)},
            "keepIndices": keep,
            "featuresIn": d,
            "featuresOut": len(keep),
        }
        return {"keep_indices": keep, "manifest": manifest.select(keep),
                "summary": summary}

    def _make_model(self, model_args):
        summary = model_args.pop("summary")
        manifest = model_args.pop("manifest")
        model = super()._make_model(model_args)
        model.summary = summary
        model.manifest = manifest
        return model


def _sanity_check(label: Feature, features: Feature, **kwargs) -> Feature:
    return SanityChecker(**kwargs).set_input(label, features).output


Feature.register_dsl("sanity_check", _sanity_check, types=(ft.RealNN,))
