"""Bucketed batch scoring of a portable device chain.

Counterpart of ``FusedScorer`` and its helpers in
``transmogrifai_tpu/workflow.py``. The port's scorer is built from the
portable IR (``portable.PortableModel``): every stage of an all-numeric
chain is a device stage, so the whole chain is the device tail. PyTorch
runs it eagerly on the scorer's device — there is no program to trace,
so shape buckets here bound the padded batch shapes the device sees
(and keep results identical to the JAX scorer's bucketed slices), not
a compile universe.

Request preparation follows the JAX package exactly: ``{column:
array}`` request data (ragged columns raise at the request's own
boundary), float boundary columns as f32 and integer columns as int32,
absent response columns as zero placeholders, and padded rows repeating
the last real row (``_pad_rows``), sliced off before results surface.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .profiling import ScoringStats

#: default serving bucket set: powers of two spanning micro-batch to
#: bulk-chunk sizes (batches above the top bucket split into top-bucket
#: slices)
DEFAULT_SCORE_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192,
                         16384, 32768)


def _normalize_buckets(buckets):
    if buckets is None:
        return None
    if buckets is True:
        return DEFAULT_SCORE_BUCKETS
    out = tuple(sorted({int(b) for b in buckets}))
    if not out or out[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets!r}")
    return out


def _pad_rows(col: np.ndarray, rows: int) -> np.ndarray:
    """Edge-pad axis 0 to `rows` (repeat the last real row: realistic
    values, no NaN/overflow surprises in padded lanes; padded outputs
    are sliced off before anything reads them). An empty column zero-
    pads (no last row to repeat)."""
    n = col.shape[0]
    if n == rows:
        return col
    if n == 0:
        return np.zeros((rows,) + col.shape[1:], col.dtype)
    return np.concatenate([col, np.repeat(col[-1:], rows - n, axis=0)])


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device`` without a stream sync (the
    copy is queued on the current stream; the one sync of a batch is
    the ``.cpu()`` in finalize)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device, non_blocking=True)


def request_columns(data) -> Tuple[int, Dict[str, Any]]:
    """Normalize one request's ``{column: array}`` data (or an object
    whose ``.columns`` is such a dict) -> (rows, columns). Raises on a
    non-dict, an empty request, or ragged columns — failing the ragged
    request at ITS OWN submit, before coalescing could hide it."""
    cols = (data.columns if hasattr(data, "columns")
            and isinstance(getattr(data, "columns"), dict) else data)
    if not isinstance(cols, dict):
        raise TypeError("scoring expects {column: array} request data")
    n = first = None
    for k, v in cols.items():
        m = len(np.asarray(v))
        if n is None:
            n, first = m, k
        elif m != n:
            raise ValueError(
                f"request column {k!r} has {m} rows but {first!r} "
                f"has {n}; all supplied columns must share one length")
    if n is None:
        raise ValueError("request supplied no columns")
    return n, cols


class FusedScorer:
    """Bucketed batch scoring: the portable chain as ONE device tail.

    Built by ``PortableModel.compile_scoring()`` (or directly). Every
    stage of the chain runs on ``device`` (None: the model's own
    device). Serving-grade extras as in the JAX package:

    * **Shape bucketing** (`buckets=True` or an ascending int tuple):
      every batch's row count pads up to the smallest bucket that fits
      (batches above the top bucket split into top-bucket slices).
      Padded rows are sliced off before results surface — the device
      tail is a composition of row-level functions, so padding never
      leaks into real rows.
    * **Observability** (`self.stats`): per-bucket batch/row/padded-row
      counters (profiling.ScoringStats).

    Exposes what the fused serving plane reads (serving/fusion.py):
    ``device_infos`` (input names, device fn, output name per stage),
    ``device_stage_by_output``, ``boundary``, ``_response_boundary``,
    ``result_names`` and ``buckets``."""

    def __init__(self, model, buckets=None, device=None):
        if device is not None:
            model = model.to(resolve_device(device))
        self.model = model
        self.device = model.device
        self.buckets = _normalize_buckets(buckets)
        self.stats = ScoringStats()
        stages = model.stages
        infos: List[Tuple[List[str], Callable, str]] = [
            (st.input_names, st.make_device_fn(), st.output_name)
            for st in stages]
        self.device_infos = infos
        self.device_stage_by_output = {st.output_name: st for st in stages}

        produced: set = set()
        boundary: List[str] = []
        for in_names, _, out in infos:
            for n in in_names:
                if n not in produced and n not in boundary:
                    boundary.append(n)
            produced.add(out)
        self.boundary = boundary
        self.result_names = [n for n in model.result_names
                             if n in produced]
        self._response_boundary = {
            n for n in boundary if n in model.response_boundary}

        device_outputs = tuple(self.result_names)

        def fused(bvals):
            cols = dict(zip(boundary, bvals))
            for in_names, fn, out in infos:
                cols[out] = fn(*[cols[n] for n in in_names])
            return tuple(cols[n] for n in device_outputs)

        self._fn = fused

    def run_tail(self, dev_vals: Sequence[torch.Tensor]):
        """The device tail over one padded slice's boundary tensors."""
        with torch.inference_mode():
            return self._fn(dev_vals)

    def _boundary_host(self, data) -> Tuple[int, List[np.ndarray]]:
        """Host-side boundary columns in their device dtypes: integer
        columns int32 (hashed ids must NOT round-trip through f32),
        everything else f32; absent response columns become zero
        placeholders; any other absent column raises."""
        n, cols = request_columns(data)
        vals = []
        for name in self.boundary:
            if name in cols:
                col = np.asarray(cols[name])
                if np.issubdtype(col.dtype, np.integer):
                    vals.append(col.astype(np.int32))
                else:
                    vals.append(col.astype(np.float32))
            elif name in self._response_boundary:
                vals.append(np.zeros((n,), np.float32))
            else:
                raise ValueError(
                    f"fused scoring input {name!r} missing from data")
        return n, vals

    def _bucket_slices(self, n: int):
        """Yield (start, stop, padded_rows) row slices covering [0, n).

        Unbucketed: one exact-shape slice. Bucketed: slices of the top
        bucket, then the remainder padded up to the smallest bucket
        that fits (an EMPTY batch pads to the smallest bucket)."""
        if self.buckets is None:
            yield 0, n, n
            return
        if n == 0:
            yield 0, 0, self.buckets[0]
            return
        top = self.buckets[-1]
        start = 0
        while n - start > top:
            yield start, start + top, top
            start += top
        rem = n - start
        yield start, n, next(b for b in self.buckets if b >= rem)

    def _dispatch(self, n: int, vals: Sequence[np.ndarray]):
        """Launch the device tail for one chunk; returns in-flight parts
        (device work is queued on the current stream, not waited on)."""
        parts = []
        for start, stop, bucket in self._bucket_slices(n):
            dev = [to_device(_pad_rows(v[start:stop], bucket), self.device)
                   for v in vals]
            outs = self.run_tail(dev)
            self.stats.note_batch(bucket, stop - start)
            parts.append((stop - start, outs))
        return parts

    def _finalize(self, parts) -> Dict[str, np.ndarray]:
        """Materialize one chunk's in-flight parts, slicing padding off."""
        pieces: List[List[np.ndarray]] = [[] for _ in self.result_names]
        for m, outs in parts:
            for acc, o in zip(pieces, outs):
                acc.append(o[:m].cpu().numpy())
        return {name: (ps[0] if len(ps) == 1
                       else np.concatenate(ps, axis=0))
                for name, ps in zip(self.result_names, pieces)}

    def score_arrays(self, data) -> Dict[str, np.ndarray]:
        """One-call batch scoring of ``{column: array}`` data ->
        {result name: (n, k) f32 array}."""
        with self.stats.timed():
            n, vals = self._boundary_host(data)
            return self._finalize(self._dispatch(n, vals))
