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
* otherwise — the stacked pass, in one of two forms, which each
  member's :class:`StackSpec` records (``form``):

  - ``"table"``: the prefix (the device stages before the head) is
    made of the stages :func:`compile_prefix` knows (impute with null
    indicators, concat, keep_cols over scalar and vector boundary
    columns). For the boundary shapes a slice carries, the compiler
    turns each member's prefix into three tables over its head's
    features. A bucket slice packs its boundary values (a vector
    column as that many consecutive columns) and model ids into one
    (pinned, on CUDA) host buffer, copies it to the device once, and
    ``fused_prefix_scores`` builds every row's features through its
    own model's tables, scores all K heads and applies the activation:
    one copy in, one kernel launch, one copy out.
  - ``"generic"``: any other prefix (a user stage with its own
    ``make_device_fn``, an inner predict feeding the head). The JAX
    formulation: each member's own prefix runs on the gathered
    boundary tensors, a per-row ``where`` selects each row's feature
    block by model id, and ``fused_linear_scores`` (the kernel's
    identity table) scores all K heads through the activation in one
    launch.

  Both run in the serving dtype (bf16 operands on CUDA, f32 on the CPU
  and under ``TM_KERNEL_EXACT=1``; f32 accumulation). The kernel is
  chosen by the tensors' device: the CUDA kernel on the card, its
  plain PyTorch version on the CPU. On the card exact mode only pins
  f32 operands: the fused plane never leaves the kernel there.

Stackability is DETECTED, not declared, by the JAX package's checks:
one result, a terminal device stage that is a PredictionModel of a
linear family (LogisticRegression / LinearRegression / LinearSVC — one
affine map + a fixed activation) with two inputs, nothing after it.
Anything else falls back LOUDLY: the engine counts
``fused_fallbacks`` and flight-records the first occurrence per
backend, and those groups keep the Python-layer co-batching path. A
member that passes detection is never moved to the classic plane: if
its slice cannot be built or launched, its requests fail.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models import serving_kernels as _sk
from ..ops import (BinaryVectorizer, RealVectorizerModel,
                   SanityCheckerModel, VectorsCombiner)
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


#: the forms of a stacked pass (StackSpec.form): the prefix tables in
#: the kernel, or each member's own prefix before the identity table
TABLE, GENERIC = "table", "generic"


class StackSpec:
    """Stackable-head metadata for one backend: everything the fused
    group scorer needs to put this model's rows in a shared launch."""

    __slots__ = ("family", "act", "form", "p", "L", "n_out", "W",
                 "feature_name", "result_name", "boundary",
                 "response_boundary", "buckets", "device")

    def __init__(self, family, act, form, W, feature_name, result_name,
                 boundary, response_boundary, buckets, device):
        self.family = family
        self.act = act              # "sigmoid_pair" | "softmax" | "identity"
        self.form = form            # TABLE | GENERIC
        self.W = W                  # (p+1, L) f32 tensor, last row = intercept
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
        form, same gathered-boundary layout, same bucket universe, same
        stacked head shape and activation, same scattered result width,
        same device. Each boundary column's width rides in the engine's
        request signature beside this key (a portable artifact records
        no widths, its requests do), so members whose pivot
        vocabularies differ never pool. The key is MODE-INDEPENDENT
        (exact vs stacked) so a flipped TM_KERNEL_EXACT regroups
        identically and only the scorer cache (keyed on the serve
        policy token) rebuilds."""
        return (self.form, self.act, self.p, self.L, self.n_out,
                self.boundary, tuple(sorted(self.response_boundary)),
                self.buckets, str(self.device))


def slot_widths(shapes: Sequence[tuple]) -> List[int]:
    """Slots each boundary column takes in a packed slice: one for a
    scalar column (shape ()), w for a vector column (shape (w,))."""
    return [int(np.prod(s, dtype=np.int64)) for s in shapes]


def compile_prefix(sc, feature_name: str,
                   shapes: Optional[Sequence[tuple]] = None
                   ) -> Optional[tuple]:
    """A scorer's device prefix — every stage before its head — as
    three tables over the head's feature block ``feature_name``:
    ``src`` (int32, the packed slot a feature reads), ``op`` (uint8,
    ``OP_VALUE``, ``OP_FILLED`` or ``OP_NULL``) and ``fill`` (f32, the
    fill value as the eager impute rounds it). ``shapes`` gives each
    boundary column's trailing shape, as a slice's values carry it:
    () a scalar column (one slot), (w,) a vector column (w consecutive
    slots, :func:`pack_slice`'s layout). None checks the structure
    alone, each column one slot: that is what :func:`stack_spec_of`
    asks at publish time, before a request has shown the widths.

    Recognises the fitted impute stages (portable op ``impute``:
    :class:`RealVectorizerModel` and :class:`BinaryVectorizer`, filled
    value, then the null indicator when it tracks nulls) over a scalar
    boundary column, :class:`VectorsCombiner` (concat in input order)
    and :class:`SanityCheckerModel` (keep_cols; its label input is never
    read), each of the last two reading earlier blocks or boundary
    columns (every slot as is), and nothing else: any other stage, an
    impute reading anything but a scalar boundary column, or a keep
    outside its block gives None."""
    slot: Dict[str, tuple] = {}     # boundary name -> (first slot, shape)
    at = 0
    for i, name in enumerate(sc.boundary):
        shape = () if shapes is None else tuple(shapes[i])
        if len(shape) > 1:
            return None
        slot[name] = (at, shape)
        at += slot_widths([shape])[0]
    blocks: Dict[str, list] = {}     # output name -> [(src, op, fill)]

    def read(name):
        if name in blocks:
            return blocks[name]
        if name not in slot:
            return None
        first, shape = slot[name]
        return [(first + j, _sk.OP_VALUE, np.float32(0.0))
                for j in range(slot_widths([shape])[0])]

    for in_names, _fn, out in sc.device_infos[:-1]:
        st = sc.device_stage_by_output[out]
        if isinstance(st, (RealVectorizerModel, BinaryVectorizer)):
            if len(in_names) != 1 or in_names[0] not in slot \
                    or slot[in_names[0]][1] != ():
                return None
            c = slot[in_names[0]][0]
            feats = [(c, _sk.OP_FILLED, np.float32(st.params["fill_value"]))]
            if st.params["track_nulls"]:
                feats.append((c, _sk.OP_NULL, np.float32(0.0)))
        elif isinstance(st, VectorsCombiner):
            parts = [read(b) for b in in_names]
            if any(f is None for f in parts):
                return None
            feats = [f for part in parts for f in part]
        elif isinstance(st, SanityCheckerModel):
            base = read(in_names[1]) if len(in_names) == 2 else None
            if base is None:
                return None
            if shapes is None:
                feats = base        # widths unknown: the keep waits
            else:
                keep = np.asarray(st.params["keep_indices"], np.int64)
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
    affine head — the JAX package's checks: one result, a terminal
    PredictionModel of a stackable family with two inputs, no device
    stage after it; None means 'serve it the classic way' (multi-result
    models, non-linear families, post-predict device stages). The spec
    records the form that serves the backend: ``TABLE`` when
    :func:`compile_prefix` knows the prefix's structure, else
    ``GENERIC``. Never raises: detection runs at registry publish time
    and a detector bug must not take a version out of service — the
    engine counts every fallback (``fused_fallbacks``), so a detection
    bug shows there."""
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
        form = (TABLE if compile_prefix(sc, term_inputs[1]) is not None
                else GENERIC)
        return StackSpec(family, act, form, W, term_inputs[1],
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
    one bucket slice: the (bucket, C) boundary values row-major — a
    scalar column one column of it, a vector column of width w that
    many consecutive columns, so C is the sum of the widths
    (:func:`slot_widths`) — then the model ids' int32 bits. Padded rows
    repeat the last real row, as ``_pad_rows`` does (zeros for an empty
    slice). An int32 column rounds to f32 to nearest, as the eager
    prefix's ``.to(torch.float32)`` does."""
    m = len(mid)
    widths = slot_widths([np.shape(v)[1:] for v in vals])
    C = sum(widths)
    V = host[:bucket * C].reshape(bucket, C)
    ids = host[bucket * C:].view(np.int32)
    at = 0
    for v, w in zip(vals, widths):
        V[:m, at:at + w] = np.reshape(v, (m, w))
        at += w
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
    per slice). The members share one form (it is in the fuse key).
    The engine caches instances keyed on (member backend ids, request
    signature, serve policy token): strong refs to the member backends
    below make the id()s stable for the cache's lifetime."""

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
        self.form = s0.form
        #: result column name per model index (scatter uses each
        #: request's OWN backend's name)
        self.result_names = tuple(s.result_name for s in specs)
        self.exact = _sk.kernel_exact()
        self.policy_token = _sk.serve_policy_token(self.device)
        self._slices = self.backends[0].scorer._bucket_slices
        #: exact mode on the CPU: each member's OWN full tail on the
        #: shared boundary; the where-select keeps every row bitwise on
        #: its own model's result (ops are row-independent) — K tails,
        #: and the plain version is not called either (None otherwise)
        self._tails = None
        if self.exact and self.device.type == "cpu":
            self._tails = self._chains = [
                (b.scorer.device_infos, s.result_name) for b, s in members]
            return
        # the stacked pass: the members' heads stacked once in member
        # order (the model index a row rides under indexes W and the
        # prefix tables alike)
        self.W = torch.stack([s.W for s in specs]).to(
            torch.float32).contiguous()
        self.act = s0.act
        self.dtype = _sk.serve_dtype(self.device)
        self._p = s0.p
        if self.form == TABLE:
            #: boundary shapes -> the stacked (src, op, fill) tables on
            #: the device, compiled at the first slice of those shapes
            self._tables: Dict[tuple, tuple] = {}
            self._feature_names = [s.feature_name for s in specs]
            # pinned staging: a non_blocking copy from pageable memory
            # would run synchronously. Each slice takes a fresh buffer
            # from PyTorch's caching host allocator, which holds a block
            # until the copy reading it has finished — the engine
            # launches the next pass before it finalizes this one, so a
            # buffer reused by hand could be overwritten mid-copy.
            self._pin = self.device.type == "cuda"
        else:
            self._chains = [(b.scorer.device_infos[:-1], s.feature_name)
                            for b, s in members]

    def _selected(self, bucket: int, vals: Sequence[np.ndarray],
                  mid: np.ndarray) -> tuple:
        """One slice's boundary values and model ids on the device, each
        member's own chain (its tail, or its prefix) run on them, and
        each row's f32 output taken from its own member: (outputs, the
        model ids on the device)."""
        mid_b = to_device(_pad_rows(mid, bucket), self.device)
        bvals = [to_device(_pad_rows(v, bucket), self.device) for v in vals]
        out = None
        for k, (infos, name) in enumerate(self._chains):
            cols = dict(zip(self.boundary, bvals))
            for in_names, fn, outname in infos:
                cols[outname] = fn(*[cols[nm] for nm in in_names])
            ok = cols[name].to(torch.float32)
            out = ok if out is None else torch.where(
                (mid_b == k)[:, None], ok, out)
        return out, mid_b

    def tables(self, shapes: tuple) -> tuple:
        """The members' prefix tables for slices of boundary ``shapes``,
        stacked (K, p) on the device; raises when a member's prefix does
        not compile to its head's p features at those shapes."""
        got = self._tables.get(shapes)
        if got is None:
            per = []
            for b, name in zip(self.backends, self._feature_names):
                t = compile_prefix(b.scorer, name, shapes)
                if t is None or len(t[0]) != self._p:
                    raise ValueError(
                        f"fused serving: the prefix of {name!r} does not "
                        f"give its head's {self._p} features over "
                        f"boundary shapes {shapes}")
                per.append(t)
            got = self._tables[shapes] = tuple(
                torch.from_numpy(np.stack([t[i] for t in per])).to(
                    self.device) for i in range(3))
        return got

    def kernel_inputs(self, bucket: int, vals: Sequence[np.ndarray],
                      mid: np.ndarray) -> tuple:
        """One bucket slice's kernel arguments on the device (the stacked
        pass). The table form: (V, mid, src, op, fill, W) for
        ``fused_prefix_scores`` — one host buffer (:func:`pack_slice`),
        one copy to the device, two views of it, and the tables for the
        slice's boundary shapes. The generic form: (X, W, mid) for
        ``fused_linear_scores`` — each member's own prefix on the
        slice's boundary tensors, each row's feature block selected by
        its model id."""
        if self.form == TABLE:
            shapes = tuple(np.shape(v)[1:] for v in vals)
            C = sum(slot_widths(shapes))
            buf = torch.empty(bucket * (C + 1), dtype=torch.float32,
                              pin_memory=self._pin)
            pack_slice(buf.numpy(), bucket, vals, mid)
            dev = buf.to(self.device, non_blocking=True)
            return ((dev[:bucket * C].view(bucket, C),
                     dev[bucket * C:].view(torch.int32))
                    + self.tables(shapes) + (self.W,))
        feats, mid_b = self._selected(bucket, vals, mid)
        return feats.contiguous(), self.W, mid_b

    def score(self, args: tuple) -> torch.Tensor:
        """One launch of the kernel on :meth:`kernel_inputs`' arguments,
        through the head's activation, in the serving dtype."""
        fn = (_sk.fused_prefix_scores if self.form == TABLE
              else _sk.fused_linear_scores)
        return fn(*args, act=self.act, dtype=self.dtype)

    def launch(self, n: int, vals: Sequence[np.ndarray],
               mid: np.ndarray) -> List[tuple]:
        """Queue the fused launch per bucket slice; returns in-flight
        parts for finalize (nothing here waits on the device)."""
        mid = np.ascontiguousarray(mid, np.int32)
        parts = []
        with torch.inference_mode():
            for start, stop, bucket in self._slices(n):
                sv, sm = [v[start:stop] for v in vals], mid[start:stop]
                out = (self.score(self.kernel_inputs(bucket, sv, sm))
                       if self._tails is None
                       else self._selected(bucket, sv, sm)[0])
                parts.append((stop - start, out))
        return parts

    def finalize(self, parts: Sequence[tuple]) -> np.ndarray:
        """(n, n_out) f32 scores in submission row order."""
        chunks = [o[:m].cpu().numpy() for m, o in parts]
        return (chunks[0] if len(chunks) == 1
                else np.concatenate(chunks, axis=0))
