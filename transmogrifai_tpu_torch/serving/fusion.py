"""Cross-model fusion plane: stackability metadata + the fused group
scorer behind TM_SERVE_FUSED_KERNEL.

Counterpart of ``transmogrifai_tpu/serving/fusion.py``. The engine's
dispatcher co-batches requests that share a BACKEND; this module fuses
across backends of one *family*: K warm linear models whose device
tails end in a stackable affine head score as ONE launch per (family,
bucket) — the engine gathers all K sub-batches' rows, tags each row
with its model index, and the fused kernel selects per-row results on
the device (models/serving_kernels.py). K launches become one.

Two formulations, switched by the kernel parity policy:

* ``TM_KERNEL_EXACT=1`` on the CPU — each member model's OWN full
  device tail runs on the shared gathered boundary values and a per-row
  ``where`` selects each row's model. Every op is row-independent
  (impute / combine / sanity / predict), so each row sees EXACTLY what
  its own backend computes — bitwise-identical to per-backend scoring
  by construction (the validation anchor).
* otherwise — the stacked pass. At publish time :func:`compile_prefix`
  turns each member's prefix (the device stages before its head:
  impute with null indicators, concat, keep_cols) into three tables
  over its head's features, stored on its :class:`StackSpec` beside the
  head's (p+1, L) weights. A bucket slice then packs its boundary
  values and model ids into one (pinned, on CUDA) host buffer, copies
  it to the device once, and ``fused_prefix_scores`` builds every
  row's features through its own model's tables, scores all K heads
  and applies the activation, in the serving dtype (bf16 operands on
  CUDA, f32 on the CPU and under ``TM_KERNEL_EXACT=1``; f32
  accumulation): one copy in, one kernel launch, one copy out. The
  kernel is chosen by the tensors' device: the CUDA kernel on the card,
  its plain PyTorch version on the CPU. On the card exact mode only
  pins f32 operands: the fused plane never leaves the kernel there.

Stackability is DETECTED, not declared: the terminal device stage must
be a PredictionModel of a linear family (LogisticRegression /
LinearRegression / LinearSVC — one affine map + a fixed activation),
and every stage before it one the prefix compiler knows. Anything else
falls back LOUDLY: the engine counts ``fused_fallbacks`` and
flight-records the first occurrence per backend, and those groups keep
the Python-layer co-batching path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models import serving_kernels as _sk
from ..ops import RealVectorizerModel, SanityCheckerModel, VectorsCombiner
from ..workflow import _pad_rows, to_device

#: strict TM_SERVE_FUSED_* catalog (parse_env_fields). The JAX
#: package's TM_SERVE_FUSED_PALLAS has no counterpart: the port has no
#: Pallas and the kernel follows the tensors' device, so the strict
#: parse rejects that name loudly.
_FUSED_ENV_FIELDS: Dict[str, tuple] = {
    "TM_SERVE_FUSED_KERNEL": ("fused_kernel", int),
    "TM_SERVE_FUSED_MIN_MODELS": ("fused_min_models", int),
}

#: model families whose device tail ends in one affine map + fixed
#: activation — the set the stacked contraction can express
STACKABLE_FAMILIES = ("LogisticRegression", "LinearRegression",
                      "LinearSVC")


def fused_env_fields(environ=None, **overrides) -> Dict[str, object]:
    """Parse the TM_SERVE_FUSED_* knobs (strict: unknown name or bad
    value raises). Returns whichever of {fused_kernel,
    fused_min_models} are set."""
    from ..resilience.config import parse_env_fields
    return parse_env_fields("TM_SERVE_FUSED", _FUSED_ENV_FIELDS,
                            what="fused-serving env var",
                            environ=environ, overrides=overrides)


class StackSpec:
    """Stackable-head metadata for one backend: everything the fused
    group scorer needs to put this model's rows in a shared launch."""

    __slots__ = ("family", "act", "p", "L", "n_out", "W", "src", "op",
                 "fill", "feature_name", "result_name", "boundary",
                 "response_boundary", "buckets", "device")

    def __init__(self, family, act, W, tables, feature_name, result_name,
                 boundary, response_boundary, buckets, device):
        self.family = family
        self.act = act              # "sigmoid_pair" | "softmax" | "identity"
        self.W = W                  # (p+1, L) f32 tensor, last row = intercept
        #: the prefix tables (compile_prefix): (p,) int32 boundary
        #: column, uint8 op, f32 fill per head feature, on ``device``
        self.src, self.op, self.fill = (
            torch.from_numpy(t).to(device) for t in tables)
        self.p = int(W.shape[0]) - 1
        self.L = int(W.shape[1])
        self.n_out = 2 if act == "sigmoid_pair" else self.L
        self.feature_name = feature_name
        self.result_name = result_name
        self.boundary = tuple(boundary)
        self.response_boundary = frozenset(response_boundary)
        self.buckets = buckets
        self.device = torch.device(device)

    def fuse_key(self) -> tuple:
        """Backends sharing this key can ride one fused launch: same
        gathered-boundary layout, same bucket universe, same stacked
        head shape and activation, same scattered result width, same
        device. The key is MODE-INDEPENDENT (exact vs stacked) so a
        flipped TM_KERNEL_EXACT regroups identically and only the
        scorer cache (keyed on the serve policy token) rebuilds."""
        return (self.act, self.p, self.L, self.n_out, self.boundary,
                tuple(sorted(self.response_boundary)), self.buckets,
                str(self.device))


def compile_prefix(sc, feature_name: str) -> Optional[tuple]:
    """A scorer's device prefix — every stage before its head — as
    three tables over the head's feature block ``feature_name``:
    ``src`` (int32, the boundary column a feature reads), ``op`` (uint8,
    ``OP_FILLED`` or ``OP_NULL``) and ``fill`` (f32, the fill value as
    the eager impute rounds it). Recognises the fitted impute stage
    (:class:`RealVectorizerModel`: filled value, then the null
    indicator when it tracks nulls), :class:`VectorsCombiner` (concat
    in input order) and :class:`SanityCheckerModel` (keep_cols; its
    label input is never read), and nothing else: any other stage, an
    impute reading anything but a boundary column, or a block the head
    cannot read gives None."""
    column = {name: i for i, name in enumerate(sc.boundary)}
    blocks: Dict[str, list] = {}     # output name -> [(src, op, fill)]
    for in_names, _fn, out in sc.device_infos[:-1]:
        st = sc.device_stage_by_output[out]
        if isinstance(st, RealVectorizerModel):
            if len(in_names) != 1 or in_names[0] not in column:
                return None
            c = column[in_names[0]]
            feats = [(c, _sk.OP_FILLED, np.float32(st.params["fill_value"]))]
            if st.params["track_nulls"]:
                feats.append((c, _sk.OP_NULL, np.float32(0.0)))
        elif isinstance(st, VectorsCombiner):
            if not all(b in blocks for b in in_names):
                return None
            feats = [f for b in in_names for f in blocks[b]]
        elif isinstance(st, SanityCheckerModel):
            if len(in_names) != 2 or in_names[1] not in blocks:
                return None
            base = blocks[in_names[1]]
            keep = st.params["keep_indices"].cpu().numpy()
            if ((keep < 0) | (keep >= len(base))).any():
                return None
            feats = [base[i] for i in keep]
        else:
            return None
        blocks[out] = feats
    feats = blocks.get(feature_name)
    if not feats:
        return None
    return (np.array([f[0] for f in feats], np.int32),
            np.array([f[1] for f in feats], np.uint8),
            np.array([f[2] for f in feats], np.float32))


def stack_spec_of(backend) -> Optional[StackSpec]:
    """Detect whether ``backend``'s device tail ends in a stackable
    affine head behind a prefix :func:`compile_prefix` knows; None means
    'serve it the classic way' (multi-result models, non-linear
    families, post-predict device stages, other prefix stages). Never
    raises: detection runs at registry publish time and a detector bug
    must not take a version out of service — the engine counts every
    fallback (``fused_fallbacks``), so a detection bug shows there."""
    sc = getattr(backend, "scorer", None)
    if sc is None:
        return None
    try:
        infos = sc.device_infos
        if not infos or len(sc.result_names) != 1:
            return None
        result_name = sc.result_names[0]
        if infos[-1][2] != result_name:
            # device stages AFTER the predict head consume its output:
            # the stacked contraction can't reproduce that tail
            return None
        from ..models.base import PredictionModel
        st = sc.device_stage_by_output.get(result_name)
        if not isinstance(st, PredictionModel):
            return None
        family = st.params.get("family")
        if family not in STACKABLE_FAMILIES:
            return None
        term_inputs = infos[-1][0]
        if len(term_inputs) != 2:
            return None
        params = st.model_params
        n_classes = int(st.params.get("n_classes") or 2)
        if family == "LogisticRegression" and n_classes != 2:
            theta = params["theta"].to(torch.float32)
            if theta.dim() != 2:
                return None
            W, act = theta, "softmax"
        else:
            beta = params["beta"].to(torch.float32)
            if beta.dim() != 1:
                return None
            W = beta.reshape(-1, 1)
            act = ("identity" if family == "LinearRegression"
                   else "sigmoid_pair")
        tables = compile_prefix(sc, term_inputs[1])
        if tables is None or len(tables[0]) != int(W.shape[0]) - 1:
            return None
        return StackSpec(family, act, W, tables, term_inputs[1],
                         result_name, sc.boundary, sc._response_boundary,
                         sc.buckets, sc.device)
    except Exception:  # noqa: BLE001 — detection must never break serving
        return None


class BackendCaps:
    """Per-backend dispatch capabilities, resolved ONCE when the
    registry publishes the backend. Carried on the lease; the
    per-dispatch ``"run" not in backend.__dict__`` probe stays in the
    engine — an instance-wrapped run() (gating / instrumentation
    interposers) must remain the single scoring entry point even when
    it lands after registration."""

    __slots__ = ("launch", "finalize", "stack")

    def __init__(self, launch, finalize, stack):
        self.launch = launch
        self.finalize = finalize
        self.stack = stack


def backend_caps(backend) -> BackendCaps:
    launch = getattr(backend, "launch", None)
    finalize = getattr(backend, "finalize", None)
    if not (callable(launch) and callable(finalize)):
        launch = finalize = None    # two-phase needs both halves
    return BackendCaps(launch, finalize, stack_spec_of(backend))


def pack_slice(host: np.ndarray, bucket: int, vals: Sequence[np.ndarray],
               mid: np.ndarray) -> None:
    """Fill ``host``, a flat f32 array of bucket * (C + 1) words, with
    one bucket slice: the (bucket, C) boundary values row-major, then
    the model ids' int32 bits. Padded rows repeat the last real row, as
    ``_pad_rows`` does (zeros for an empty slice). An int32 column
    rounds to f32 to nearest, as the eager prefix's
    ``.to(torch.float32)`` does."""
    m, C = len(mid), len(vals)
    V = host[:bucket * C].reshape(bucket, C)
    ids = host[bucket * C:].view(np.int32)
    for c, v in enumerate(vals):
        V[:m, c] = v
    ids[:m] = mid
    if m == 0:
        host[:] = 0
    elif m < bucket:
        V[m:] = V[m - 1]
        ids[m:] = mid[m - 1]


class FusedGroupScorer:
    """One fused (family, bucket) launch over K co-batched backends.

    ``launch(n, vals, mid)`` mirrors FusedScorer._dispatch — bucketed
    padded slices, device work queued without a sync — with the per-row
    model-id vector riding along; ``finalize(parts)`` materializes the
    (n, n_out) score matrix in submission row order (the one ``.cpu()``
    per slice). The engine caches instances keyed on (member backend
    ids, dtype signature, serve policy token): strong refs to the
    member backends below make the id()s stable for the cache's
    lifetime."""

    def __init__(self, members: Sequence[tuple]):
        specs = [spec for _, spec in members]
        s0 = specs[0]
        #: strong refs — the cache key uses id(backend)
        self.backends = tuple(b for b, _ in members)
        self.K = len(members)
        self.device = s0.device
        self.boundary = s0.boundary
        self.buckets = s0.buckets
        self.n_out = s0.n_out
        #: result column name per model index (scatter uses each
        #: request's OWN backend's name)
        self.result_names = tuple(s.result_name for s in specs)
        self.exact = _sk.kernel_exact()
        self.policy_token = _sk.serve_policy_token(self.device)
        self._slices = self.backends[0].scorer._bucket_slices
        self._tails = None

        if self.exact and self.device.type == "cpu":
            # each member's OWN full tail on the shared boundary; the
            # where-select keeps every row bitwise on its own model's
            # result (ops are row-independent) — K tails, and the plain
            # version is not called either
            self._tails = [b.scorer.device_infos for b, _ in members]
            self._tail_names = [s.result_name for s in specs]
        else:
            # the stacked pass: the members' heads and prefix tables,
            # stacked once in member order (the model index a row rides
            # under indexes W and the three tables alike)
            def stack(name):
                return torch.stack([getattr(s, name) for s in specs]
                                   ).contiguous()
            self.W = stack("W").to(torch.float32)
            self.src, self.op, self.fill = (stack("src"), stack("op"),
                                            stack("fill"))
            self.act = s0.act
            self.dtype = _sk.serve_dtype(self.device)
            # pinned staging: a non_blocking copy from pageable memory
            # would run synchronously. Each slice takes a fresh buffer
            # from PyTorch's caching host allocator, which holds a block
            # until the copy reading it has finished — the engine
            # launches the next pass before it finalizes this one, so a
            # buffer reused by hand could be overwritten mid-copy.
            self._pin = self.device.type == "cuda"

    def _exact_tails(self, mid_b, bvals):
        """Exact mode on the CPU: every member's own tail, each row
        taking its own member's result."""
        out = None
        for k, infos in enumerate(self._tails):
            cols = dict(zip(self.boundary, bvals))
            for in_names, fn, outname in infos:
                cols[outname] = fn(*[cols[nm] for nm in in_names])
            ok = cols[self._tail_names[k]]
            out = ok if out is None else torch.where(
                (mid_b == k)[:, None], ok, out)
        return out

    def _stacked(self, bucket: int, vals: Sequence[np.ndarray],
                 mid: np.ndarray) -> torch.Tensor:
        """One bucket slice of the stacked pass: one host buffer
        (:func:`pack_slice`), one copy to the device, two views of it,
        one launch."""
        C = len(vals)
        buf = torch.empty(bucket * (C + 1), dtype=torch.float32,
                          pin_memory=self._pin)
        pack_slice(buf.numpy(), bucket, vals, mid)
        dev = buf.to(self.device, non_blocking=True)
        return _sk.fused_prefix_scores(
            dev[:bucket * C].view(bucket, C),
            dev[bucket * C:].view(torch.int32), self.src, self.op,
            self.fill, self.W, act=self.act, dtype=self.dtype)

    def launch(self, n: int, vals: Sequence[np.ndarray],
               mid: np.ndarray) -> List[tuple]:
        """Queue the fused launch per bucket slice; returns in-flight
        parts for finalize (nothing here waits on the device)."""
        mid = np.ascontiguousarray(mid, np.int32)
        parts = []
        with torch.inference_mode():
            for start, stop, bucket in self._slices(n):
                if self._tails is None:
                    out = self._stacked(bucket,
                                        [v[start:stop] for v in vals],
                                        mid[start:stop])
                else:
                    out = self._exact_tails(
                        to_device(_pad_rows(mid[start:stop], bucket),
                                  self.device),
                        [to_device(_pad_rows(v[start:stop], bucket),
                                   self.device) for v in vals])
                parts.append((stop - start, out))
        return parts

    def finalize(self, parts: Sequence[tuple]) -> np.ndarray:
        """(n, n_out) f32 scores in submission row order."""
        chunks = [o[:m].cpu().numpy() for m, o in parts]
        return (chunks[0] if len(chunks) == 1
                else np.concatenate(chunks, axis=0))
