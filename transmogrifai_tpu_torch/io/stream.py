"""Streaming, double-buffered host->device ingest (the port's copy of
``transmogrifai_tpu/io/stream.py``).

Reference: Spark streams executor-local partitions through each task (L0,
SURVEY §1) and Hadoop-native IO feeds them; nothing ever requires the
whole dataset in one executor's memory. The port's equivalent: an
iterator of host numpy chunks is copied to the card ahead of use —
:func:`prefetch_to_device` stages each chunk in pinned host memory and
issues its copies ``non_blocking`` on a side CUDA stream, so chunk k+1's
copy overlaps chunk k's compute; the consumer's stream waits on the
copy's event, and each tensor is recorded on the consumer's stream
(``Tensor.record_stream``) so the caching allocator never hands a
chunk's memory to the next copy while compute still reads it. The
training loop carries optimizer state across chunks, giving one-pass
(or multi-epoch) streaming fits for data larger than device memory.

The host side (:func:`host_prefetch`, :func:`double_buffer`,
:func:`csv_chunks`, :func:`csv_chunks_native`) is the JAX package's
code. Stream checkpoints (:func:`fit_streaming`) write the JAX
package's npz: the state's leaves in ``jax.tree.flatten`` order (dict
keys sorted, sequences in order), so a checkpoint written by either
package resumes in the other.
"""
from __future__ import annotations

import os

from collections import deque
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..telemetry.spans import TRACER


# ---------------------------------------------------------------------------
# pytrees of chunks and states: dicts (keys sorted, as jax flattens
# them), lists and tuples; everything else is a leaf
# ---------------------------------------------------------------------------

def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """-> (leaves, structure), leaves in ``jax.tree.flatten`` order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return ([l for ls, _ in parts for l in ls],
                ("dict", keys, [s for _, s in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(v) for v in tree]
        return ([l for ls, _ in parts for l in ls],
                (type(tree), None, [s for _, s in parts]))
    return [tree], None


def tree_unflatten(structure: Any, leaves: Iterable[Any]) -> Any:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, subs = s
        vals = [build(x) for x in subs]
        if kind == "dict":
            return dict(zip(keys, vals))
        return kind(vals)

    return build(structure)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    leaves, structure = tree_flatten(tree)
    return tree_unflatten(structure, [fn(l) for l in leaves])


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


class StreamCancelled(RuntimeError):
    """An in-flight stream was aborted via its cancel_event (engine
    shutdown, caller teardown) — distinct from producer errors so
    callers can treat it as an orderly abort, not data loss."""


def host_prefetch(chunks: Iterable[Any], buffer_size: int = 2,
                  cancel_event=None) -> Iterator[Any]:
    """Produce chunks on a BACKGROUND thread into a bounded queue.

    `prefetch_to_device` overlaps the host->device copy, but the host
    work that PRODUCES a chunk (CSV split, murmur hashing — the sparse
    front door's dominant host cost, VERDICT r4 item 5) still ran
    inline in the consumer. With the producer on its own thread, chunk
    k+1's parse/hash overlaps chunk k's device scan; the native hashing
    paths (csrc) release the GIL during the C calls, so the overlap is
    real even within one Python process. Exceptions re-raise in the
    consumer at the position they occurred.

    `cancel_event` (a threading.Event) aborts the stream from OUTSIDE:
    once set, the producer stops pulling the source iterator (between
    chunks — it cannot interrupt a chunk already being built) and the
    consumer raises StreamCancelled instead of yielding further chunks.
    A serving-engine shutdown uses this to kill an in-flight stream
    promptly rather than draining a possibly-unbounded producer."""
    import queue
    import threading

    if buffer_size < 1:
        raise ValueError("buffer_size must be >= 1")
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    _END, _ERR = object(), object()
    stop = threading.Event()

    def cancelled() -> bool:
        return cancel_event is not None and cancel_event.is_set()

    def put(item) -> bool:
        # timed puts so an abandoned consumer (step_fn raised, caller
        # broke out) can't leave this thread blocked forever holding a
        # chunk + the source iterator (review r5)
        while not stop.is_set() and not cancelled():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for c in chunks:
                if cancelled() or not put(c):
                    return
        except BaseException as e:      # noqa: BLE001 — re-raised below
            put((_ERR, e))
            return
        put(_END)

    t = threading.Thread(target=producer, daemon=True,
                         name="tm-host-prefetch")
    t.start()
    try:
        while True:
            if cancelled():
                raise StreamCancelled("host_prefetch cancelled")
            try:
                # timed get: a cancel while blocked here must still be
                # seen promptly (the producer may never put again)
                with TRACER.region("stream.wait"):
                    item = q.get(timeout=0.1 if cancel_event is not None
                                 else None)
            except queue.Empty:
                continue
            if item is _END:
                return
            if (isinstance(item, tuple) and len(item) == 2
                    and item[0] is _ERR):
                raise item[1]
            yield item
    finally:
        # generator closed (normally or not): release the producer and
        # drop whatever it had buffered
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def double_buffer(items: Iterable[Any], dispatch: Callable[[Any], Any],
                  finalize: Callable[[Any], Any], depth: int = 2
                  ) -> Iterator[Any]:
    """Pipeline `finalize(dispatch(item))` keeping `depth` dispatches in
    flight: `dispatch` launches async work (a CUDA launch returns before
    the card runs it), `finalize` blocks on its result (`.cpu()`), so item
    k+1's dispatch — and, with the producer on a host_prefetch thread,
    its host-side production — overlaps item k's device execution.

    Exception order is positional: results for every item BEFORE a
    failing producer position are finalized and yielded first, then the
    producer's exception re-raises — consumers see exactly the prefix
    that was produced. A dispatch/finalize failure drains nothing (it is
    the consumer's own error), and BaseExceptions (KeyboardInterrupt,
    SystemExit) propagate immediately rather than waiting on the
    in-flight drain."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    pending: deque = deque()
    it = iter(items)
    err: Optional[Exception] = None
    while True:
        try:
            item = next(it)
        except StopIteration:
            break
        except Exception as e:          # re-raised positionally below
            err = e
            break
        pending.append(dispatch(item))
        if len(pending) >= depth:
            yield finalize(pending.popleft())
    while pending:
        try:
            yield finalize(pending.popleft())
        except BaseException as fin_e:
            if err is not None:
                # the drain was running because the producer already
                # failed — keep that root cause chained, not swallowed
                raise fin_e from err
            raise
    if err is not None:
        raise err


def _host_array(a) -> np.ndarray:
    """A host leaf in the dtype the device gets (``jax.device_put`` with
    64-bit types off does the same): floats f32, integers int32, bools
    as they are."""
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.floating):
        return np.ascontiguousarray(a, dtype=np.float32)
    if np.issubdtype(a.dtype, np.integer):
        return np.ascontiguousarray(a, dtype=np.int32)
    return np.ascontiguousarray(a)


def _put_leaf(a, device: torch.device):
    """One leaf on ``device``: a tensor already there is used as it is
    (a device-fed chunk); a host leaf is copied, through pinned memory
    and ``non_blocking`` on CUDA (the caller holds the side stream)."""
    if isinstance(a, torch.Tensor):
        return a if a.device == device else a.to(device)
    host = torch.from_numpy(_host_array(a))
    if device.type == "cuda":
        # pin_memory copies on the host, so the caller may overwrite its
        # array as soon as this returns; the pinned block stays reserved
        # until the queued copy out of it has run
        return host.pin_memory().to(device, non_blocking=True)
    return host.clone()


def prefetch_to_device(chunks: Iterable[Any], buffer_size: int = 2,
                       device=None, host_thread: bool = False
                       ) -> Iterator[Any]:
    """Yield chunks (pytrees of arrays) as tensors on ``device`` (None:
    CUDA, raising without a card), keeping ``buffer_size`` copies in
    flight ahead of the consumer. ``host_thread=True`` additionally
    moves chunk PRODUCTION onto a background thread (see
    :func:`host_prefetch`).

    On CUDA each chunk's copies are queued on one side stream from
    pinned host memory; a yielded chunk's tensors are ready on the
    consumer's current stream (it waits on the copy's event) and are
    recorded on it, so their memory is not reused before the work the
    consumer queued on them has run. Nothing here waits on the card."""
    if buffer_size < 1:
        raise ValueError("buffer_size must be >= 1")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if host_thread:
        chunks = host_prefetch(chunks, buffer_size)
    side = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None

    def put(c):
        with TRACER.region("stream.stage"):
            if side is None:
                return tree_map(lambda a: _put_leaf(a, dev), c), None
            with torch.cuda.stream(side):
                out = tree_map(lambda a: _put_leaf(a, dev), c)
                done = torch.cuda.Event()
                done.record(side)
            return out, done

    it = iter(chunks)
    end = object()

    def pull():
        """The next host chunk, or ``end``: made here unless a producer
        thread makes it (whose queue wait is ``stream.wait``)."""
        if host_thread:
            return next(it, end)
        with TRACER.region("stream.produce"):
            return next(it, end)

    def take(item):
        out, done = item
        if done is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(done)
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(cur)
        return out

    q: deque = deque()
    c = end
    while len(q) < buffer_size and (c := pull()) is not end:
        q.append(put(c))
    while c is not end and (c := pull()) is not end:
        out = q.popleft()
        q.append(put(c))  # enqueue next transfer before the consumer blocks
        yield take(out)
    while q:
        yield take(q.popleft())


def csv_chunks(path: str, schema, chunk_rows: int = 100_000,
               **reader_kw) -> Iterator[Dict[str, np.ndarray]]:
    """Stream a CSV as column-dict chunks without loading the whole file
    (host side of the ingest pipeline; uses the same type coercion as the
    readers module). For native-speed block ingest use
    csv_chunks_native."""
    import csv as _csv

    from ..dataset import column_to_numpy
    from ..readers.core import _parse_cell

    def emit(buf, base_row):
        # cells go through the readers' _parse_cell so null tokens
        # ('NA', 'null', ...) and typed parsing match CSVProductReader —
        # raw strings into column_to_numpy crashed on 'NA' in a Real
        # column while every other reader path yielded NaN; errors name
        # file/row/column like csv_chunks_native
        out = {}
        for k, t in schema.items():
            vals = []
            for i, r in enumerate(buf):
                try:
                    vals.append(_parse_cell(r.get(k), t))
                except ValueError as e:
                    raise ValueError(f"{path} row {base_row + i + 1} "
                                     f"column {k!r}: {e}") from e
            out[k] = column_to_numpy(vals, t)
        return out

    rows_out = 0
    with open(path, newline="") as f:
        rd = _csv.DictReader(f, **reader_kw)
        buf = []
        for row in rd:
            buf.append(row)
            if len(buf) >= chunk_rows:
                yield emit(buf, rows_out)
                rows_out += len(buf)
                buf = []
        if buf:
            yield emit(buf, rows_out)


def csv_chunks_native(path: str, schema, chunk_bytes: int = 32 << 20,
                      delimiter: str = ",",
                      max_record_bytes: Optional[int] = None
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Stream a CSV as column-dict chunks through the NATIVE block
    parser: fixed-size byte blocks are cut at the last complete record
    boundary (quote-aware, `tm_csv_last_record_end`), parsed with the
    row-parallel C++ loader, and converted per the FeatureType schema —
    larger-than-RAM files ingest at native speed instead of the
    DictReader row loop (csv_chunks). Falls back to csv_chunks when the
    native library is unavailable. Declared-numeric columns parse
    C-side to float64; a block with bad numeric cells re-parses through
    the strict Python cell path so errors carry row context."""
    from .. import native
    from ..dataset import column_to_numpy
    from ..features import types as ft
    from ..readers.core import _parse_cell

    try:
        native_ok = native.available()
        if native_ok:
            native.csv_last_record_end(b"x\n", delimiter)
    except Exception:
        native_ok = False

    numeric = [n for n, t in schema.items()
               if issubclass(t, ft.OPNumeric)
               and not issubclass(t, ft.Binary)]

    def convert(cols: Dict[str, Any],
                base_row: int = 0) -> Dict[str, np.ndarray]:
        out = {}
        for name, wtype in schema.items():
            raw = cols.get(name)
            if raw is None:
                raise ValueError(f"{path}: column {name!r} missing")
            if isinstance(raw, np.ndarray):
                out[name] = (np.trunc(raw)
                             if issubclass(wtype, ft.Integral) else raw)
            elif (issubclass(wtype, ft.Text)
                  and not issubclass(wtype, (ft.OPList, ft.OPSet))):
                # plain text family: _parse_cell is strip+null-token
                # only — inline it (the per-cell call was the block's
                # hot loop); the null-token set must match _parse_cell
                from ..readers.core import _NULLS
                vals = [None if s is None or (t := s.strip()) == ""
                        or t.lower() in _NULLS else t
                        for s in raw]
                out[name] = column_to_numpy(vals, wtype)
            else:
                vals = []
                for i, s in enumerate(raw):
                    try:
                        vals.append(_parse_cell(s, wtype))
                    except ValueError as e:
                        raise ValueError(
                            f"{path} row {base_row + i + 1} column "
                            f"{name!r}: {e}") from e
                out[name] = column_to_numpy(vals, wtype)
        return out

    def _trailing_blank_len(d: bytes) -> int:
        """Length of a blank FINAL record (a line terminator directly
        after another): the C parser's EOF heuristic would drop it at a
        block boundary while the whole-file parse keeps it as a null
        row mid-file — csv_chunks_native moves it into the carry so the
        decision is made where the real EOF is."""
        for suf in (b"\r\n", b"\n"):
            if d.endswith(suf):
                rest = d[:-len(suf)]
                if rest == b"" or rest.endswith(b"\n"):
                    return len(suf)
        return 0

    if not native_ok:
        # csv_chunks shares the readers' cell/null semantics and error
        # context — one implementation, not a drifting copy
        yield from csv_chunks(path, schema,
                              chunk_rows=max(1, chunk_bytes // 64),
                              delimiter=delimiter)
        return

    header: Optional[list] = None
    rows_out = 0
    # fail-fast bound on a single record (an early unterminated quote
    # would otherwise accumulate the file into RAM, rescanning it
    # quadratically)
    max_carry = (max_record_bytes if max_record_bytes is not None
                 else max(4 * chunk_bytes, 64 << 20))
    with open(path, "rb") as f:
        carry = b""
        while True:
            block = f.read(chunk_bytes)
            if not block:
                data, carry = carry, b""
            else:
                data = carry + block
                cut = native.csv_last_record_end(data, delimiter)
                if cut == 0:
                    if len(data) > max_carry:
                        # an early unterminated quote would otherwise
                        # accumulate the whole file into RAM while
                        # rescanning it quadratically — fail fast
                        raise ValueError(
                            f"{path}: no record boundary in "
                            f"{len(data)} bytes — unterminated quote "
                            f"or a record larger than {max_carry} "
                            f"bytes?")
                    carry = data      # no complete record yet: grow
                    continue
                data, carry = data[:cut], data[cut:]
                # blank line(s) at the cut defer to the next block (see
                # _trailing_blank_len)
                while (tb := _trailing_blank_len(data)):
                    data, carry = data[:-tb], data[-tb:] + carry
            if data.strip():
                try:
                    hdr, cols = native.parse_csv_bytes(
                        data, delimiter, has_header=header is None,
                        numeric_cols=numeric, header=header)
                except ValueError:
                    # declared-numeric cell failed C-side: re-parse as
                    # strings so convert() reports file/row/column
                    hdr, cols = native.parse_csv_bytes(
                        data, delimiter, has_header=header is None,
                        numeric_cols=[], header=header)
                if header is None:
                    header = hdr
                out = convert(cols, base_row=rows_out)
                n_rows = len(next(iter(out.values()))) if out else 0
                # a header-only block would otherwise yield a zero-row
                # chunk the DictReader path never produces
                if n_rows:
                    rows_out += n_rows
                    yield out
            if not block:
                return


def fit_streaming(step_fn: Callable, state: Any, chunks: Iterable[Any],
                  epochs: int = 1, buffer_size: int = 2,
                  reiterable: Optional[Callable[[], Iterable[Any]]] = None,
                  checkpoint_dir: Optional[str] = None,
                  checkpoint_every: int = 8,
                  checkpoint_token: str = "", device=None) -> Any:
    """Drive `state = step_fn(state, device_chunk)` over a (re-)streamed
    dataset whose chunks are copied to ``device`` (None: CUDA, raising
    without a card). step_fn queues its work without waiting on the
    card, so the next chunk's copy overlaps the current chunk's compute.
    The state is a pytree of tensors on ``device``; step_fn may update
    it in place (as the JAX package's donating steps do) and returns
    it.

    For epochs > 1 pass `reiterable` (a zero-arg factory returning a fresh
    chunk iterator per epoch); plain one-shot iterators support one pass.

    Checkpoint/resume (SURVEY §5 failure recovery — Spark gets restart
    from lineage, a streaming fit must save its own): with
    `checkpoint_dir`, the state pytree is written atomically every
    `checkpoint_every` chunks, and a killed fit restarted with the SAME
    arguments resumes from the last checkpoint. Already-scanned chunks
    of the resume epoch are re-PRODUCED on the host (a deterministic
    stream can only advance by replay) but never transferred to or
    dispatched on the device. Determinism of the chunk source is the
    caller's contract, which csv_chunks and the sparse chunk factories
    satisfy. Requires `reiterable` semantics only for multi-epoch, same
    as before. The checkpoint is deleted on successful completion; a
    checkpoint inconsistent with the current call (state structure,
    dtypes, epochs, a shorter stream, a corrupt file, or — when the
    caller stamps a `checkpoint_token` — any config drift the state
    shapes cannot express, like changed hyperparameters) is rejected
    loudly."""
    if epochs > 1 and reiterable is None:
        raise ValueError("epochs > 1 needs reiterable=lambda: chunks")
    resume_epoch, resume_chunk = 0, 0
    ckpt_path = None
    if checkpoint_dir:
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        os.makedirs(checkpoint_dir, exist_ok=True)
        ckpt_path = os.path.join(checkpoint_dir, "stream_fit.ckpt.npz")
        loaded = _load_stream_checkpoint(ckpt_path, state,
                                         checkpoint_token, device)
        if loaded is not None:
            state, resume_epoch, resume_chunk = loaded
            if resume_epoch >= epochs:
                raise ValueError(
                    f"stream checkpoint {ckpt_path} is at epoch "
                    f"{resume_epoch} but this call runs epochs={epochs} "
                    f"— returning a mid-epoch state as finished would be "
                    f"silent corruption; delete it to start over")
    for e in range(resume_epoch, epochs):
        # epoch 0 always consumes the passed iterator (even when a
        # reiterable factory is also provided for later epochs)
        it = iter(chunks if e == 0 else reiterable())
        if e == resume_epoch and resume_chunk:
            # advance the HOST iterator past checkpointed chunks BEFORE
            # the prefetcher sees them: no copy, no device-memory churn
            for i in range(resume_chunk):
                try:
                    next(it)
                except StopIteration:
                    raise ValueError(
                        f"stream checkpoint {ckpt_path} is at chunk "
                        f"{resume_chunk} of epoch {e} but the stream "
                        f"produced only {i} chunks — the data source "
                        f"changed; delete the checkpoint to start over"
                    ) from None
        # host_thread: chunk production (parse/hash) overlaps the device
        # scan of the previous chunk
        base = resume_chunk if e == resume_epoch else 0
        for k, dev_chunk in enumerate(
                prefetch_to_device(it, buffer_size, device=device,
                                   host_thread=True),
                start=base):
            state = step_fn(state, dev_chunk)
            if ckpt_path and (k + 1) % checkpoint_every == 0:
                _save_stream_checkpoint(ckpt_path, state, e, k + 1,
                                        checkpoint_token)
    if ckpt_path and os.path.exists(ckpt_path):
        os.remove(ckpt_path)
    return state


def _save_stream_checkpoint(path: str, state: Any, epoch: int,
                            chunk: int, token: str = "") -> None:
    """Atomic npz of the state pytree + progress + the caller's config
    token, through the ONE shared tmp+fsync+rename path
    (resilience.atomic). The leaves are written in ``jax.tree.flatten``
    order, so the JAX package resumes the file."""
    from ..resilience.atomic import atomic_write_npz

    leaves, _ = tree_flatten(state)
    arrays = {f"leaf_{i}": (l.detach().cpu().numpy()
                            if isinstance(l, torch.Tensor)
                            else np.asarray(l))
              for i, l in enumerate(leaves)}
    arrays["__progress__"] = np.asarray([epoch, chunk], np.int64)
    arrays["__token__"] = np.asarray(token)
    atomic_write_npz(path, arrays)


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _load_stream_checkpoint(path: str, state_template: Any,
                            token: str = "", device=None):
    """-> (state, epoch, next_chunk) or None. A checkpoint whose leaf
    count/shapes/dtypes or config token mismatch the current fit is
    rejected loudly rather than silently resumed; so is a corrupt
    (truncated) file. The restored leaves are fresh tensors on
    ``device`` (None: the template's leaves' own devices)."""
    if not os.path.exists(path):
        return None
    try:
        z = np.load(path)
    except Exception as e:
        raise ValueError(
            f"stream checkpoint {path} is unreadable (truncated write? "
            f"{type(e).__name__}: {e}) — delete it to start over") from e
    with z:
        leaves, structure = tree_flatten(state_template)
        extra = [k for k in z.files
                 if k.startswith("leaf_")
                 and int(k.split("_", 1)[1]) >= len(leaves)]
        saved = [z[f"leaf_{i}"] for i in range(len(leaves))
                 if f"leaf_{i}" in z]
        if extra or len(saved) != len(leaves) or any(
                s.shape != tuple(np.shape(l)) or s.dtype != _np_dtype(l)
                for s, l in zip(saved, leaves)):
            raise ValueError(
                f"stream checkpoint {path} does not match the current "
                f"fit's state structure (changed config?) — delete it "
                f"to start over")
        saved_token = str(z["__token__"]) if "__token__" in z else ""
        if token and saved_token != token:
            raise ValueError(
                f"stream checkpoint {path} was written under a "
                f"different configuration (token {saved_token!r} != "
                f"{token!r}: changed hyperparameters or data?) — delete "
                f"it to start over")
        epoch, chunk = (int(v) for v in z["__progress__"])

        def restore(s, like):
            dev = (torch.device(device) if device is not None
                   else like.device if isinstance(like, torch.Tensor)
                   else torch.device("cpu"))
            # a copy owned by torch: the steps update the state in place,
            # so it must never alias the npz's buffers
            return torch.from_numpy(np.array(s)).to(dev)

        state = tree_unflatten(structure, [restore(s, l)
                                           for s, l in zip(saved, leaves)])
        return state, epoch, chunk
