"""Length-prefixed binary wire protocol for cross-host serving.

One frame = a fixed 20-byte header + payload::

    !2sBBQII  =  magic b"TM" | version u8 | frame-type u8
                 | correlation-id u64 | payload-length u32
                 | payload-crc32 u32

The crc32 is the gray-failure guard: a flipped bit in an array payload
(line noise, a bad NIC, the netchaos ``net-corrupt`` drill) would
otherwise decode into a silently wrong score — numpy buffer bytes
carry no internal structure to fail on. Every frame read verifies the
checksum before the payload is decoded, so corruption is always a
loud, classified :class:`WireProtocolError` that tears the connection
down (framing integrity is gone), never a wrong answer.

The correlation id ties a RESULT/ERROR frame back to the SUBMIT (or a
REPLY back to the CONTROL) that initiated it — the client keeps a
pending-futures map keyed by it, which is what makes the request
``Future`` a real async RPC instead of a blocking call. PING/PONG
carry correlation id 0 (liveness is a timestamp, not a future).

Payloads that carry arrays (SUBMIT batches, RESULT score dicts) use a
meta-JSON + raw-buffer layout::

    u32 json-length | meta JSON (utf-8) | column buffers, concatenated

where the meta's ``cols`` list records ``[name, dtype.str, shape]``
per buffer in wire order. Buffers are the C-contiguous ``tobytes()``
image of each column, decoded with ``np.frombuffer`` — byte-for-byte,
so NaN payload bits and ±inf survive the round trip bitwise (pinned
by tests/test_transport.py). Object dtypes (Text columns) are NOT
wire-serializable; the encoder rejects them loudly.

Errors cross the wire as ``{etype, message, retryable}`` JSON and are
reconstructed through :data:`ERROR_TYPES` — the serving admission
taxonomy by class name — so the fleet router's retryable/terminal
classification works identically for a remote engine. An unknown
remote type degrades to :class:`RemoteError` carrying the sender's
``retryable`` verdict rather than guessing.

Every decode failure (bad magic, version skew, truncated frame,
corrupt meta) raises a classified :class:`WireProtocolError` — never
a silent partial read, never a hung future.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ...dataset import Dataset
from ...features import types as ftypes
from ..admission import (DeadlineExpired, DeadlineUnmeetable, EngineClosed,
                         EngineStopped, QueueFull, RejectedError,
                         TenantBudgetExceeded)
from ..registry import ModelNotFound

__all__ = [
    "MAGIC", "WIRE_VERSION", "HEADER",
    "T_SUBMIT", "T_RESULT", "T_ERROR", "T_CONTROL", "T_REPLY",
    "T_PING", "T_PONG",
    "WireProtocolError", "RemoteError", "WorkerUnavailable",
    "encode_frame", "split_header", "decode_header", "check_crc",
    "encode_submit", "decode_submit",
    "encode_result", "decode_result",
    "encode_error", "decode_error",
    "encode_control", "decode_control",
]

MAGIC = b"TM"
WIRE_VERSION = 2        # v2: payload crc32 joined the header

#: frame header: magic, version, frame type, correlation id,
#: payload len, payload crc32
HEADER = struct.Struct("!2sBBQII")

#: sanity bound on a single frame payload (guards a corrupt length
#: prefix from allocating gigabytes before the magic check can matter)
MAX_PAYLOAD_BYTES = 1 << 31

T_SUBMIT = 1    #: client -> worker: score this batch
T_RESULT = 2    #: worker -> client: scores for a SUBMIT
T_ERROR = 3     #: worker -> client: classified failure for a SUBMIT
T_CONTROL = 4   #: client -> worker: JSON control op (ready/stats/...)
T_REPLY = 5     #: worker -> client: JSON reply for a CONTROL
T_PING = 6      #: either direction: liveness probe (corr id 0)
T_PONG = 7      #: liveness ack

_FRAME_TYPES = frozenset((T_SUBMIT, T_RESULT, T_ERROR, T_CONTROL,
                          T_REPLY, T_PING, T_PONG))


class WireProtocolError(RuntimeError):
    """A frame that cannot be decoded (truncation, corruption, version
    skew). Terminal for the frame, fatal for the connection — the
    stream offset is unrecoverable once framing is lost."""
    retryable = False


class RemoteError(RuntimeError):
    """A worker-side failure whose type has no local class. Carries the
    sender's retryable verdict so router classification still works."""

    def __init__(self, message: str, retryable: bool = False,
                 etype: str = "RemoteError"):
        super().__init__(message)
        self.retryable = bool(retryable)
        self.etype = etype


class WorkerUnavailable(EngineClosed):
    """The transport lost its worker (connection refused/reset, worker
    killed, heartbeat expired). Subclasses EngineClosed so the fleet
    router classifies it retryable and fails over — the zero
    accepted-request-loss path when a worker dies mid-flight."""
    retryable = True


#: admission/registry taxonomy, reconstructable by class name. The
#: wire adds nothing: a remote QueueFull IS a QueueFull locally, so
#: breaker penalties and failover policy are transport-agnostic.
ERROR_TYPES = {cls.__name__: cls for cls in (
    RejectedError, QueueFull, TenantBudgetExceeded, DeadlineUnmeetable,
    DeadlineExpired, EngineClosed, EngineStopped, ModelNotFound,
    WorkerUnavailable, WireProtocolError,
    ValueError, TypeError, KeyError, RuntimeError, TimeoutError,
)}


def encode_frame(ftype: int, corr: int, payload: bytes = b"") -> bytes:
    """Header + payload, ready for one ``sendall``."""
    return HEADER.pack(MAGIC, WIRE_VERSION, ftype, corr, len(payload),
                       zlib.crc32(payload) & 0xFFFFFFFF) + payload


def decode_header(header: bytes) -> Tuple[int, int, int, int]:
    """``(frame_type, correlation_id, payload_len, payload_crc)`` from
    the header bytes; raises :class:`WireProtocolError` on corruption."""
    if len(header) != HEADER.size:
        raise WireProtocolError(
            f"truncated frame header: {len(header)} of {HEADER.size} "
            f"bytes")
    magic, version, ftype, corr, plen, crc = HEADER.unpack(header)
    if magic != MAGIC:
        raise WireProtocolError(f"bad frame magic {magic!r}")
    if version != WIRE_VERSION:
        raise WireProtocolError(
            f"wire version skew: got {version}, speak {WIRE_VERSION}")
    if ftype not in _FRAME_TYPES:
        raise WireProtocolError(f"unknown frame type {ftype}")
    if plen > MAX_PAYLOAD_BYTES:
        raise WireProtocolError(
            f"frame payload length {plen} exceeds "
            f"{MAX_PAYLOAD_BYTES} byte bound")
    return ftype, corr, plen, crc


def check_crc(payload: bytes, crc: int, ftype: int) -> None:
    """Verify a payload against its header checksum — the integrity
    gate every read path passes before decoding a byte."""
    got = zlib.crc32(payload) & 0xFFFFFFFF
    if got != crc:
        raise WireProtocolError(
            f"payload crc mismatch on frame type {ftype}: header says "
            f"{crc:#010x}, payload hashes to {got:#010x} — corrupt "
            f"frame, connection integrity lost")


def split_header(buf: bytes) -> Tuple[int, int, bytes]:
    """Decode one complete frame held in ``buf``:
    ``(frame_type, correlation_id, payload)``. Raises on truncation
    or a payload that fails its header crc."""
    ftype, corr, plen, crc = decode_header(buf[:HEADER.size])
    payload = buf[HEADER.size:]
    if len(payload) != plen:
        raise WireProtocolError(
            f"truncated frame payload: {len(payload)} of {plen} bytes")
    check_crc(payload, crc, ftype)
    return ftype, corr, payload


# -- array payload codec -------------------------------------------------

def _encode_arrays(meta: Dict[str, Any],
                   arrays: "list[tuple[str, np.ndarray]]") -> bytes:
    cols = []
    bufs = []
    for name, arr in arrays:
        arr = np.asarray(arr)
        if arr.dtype.hasobject:
            raise WireProtocolError(
                f"column {name!r} has object dtype {arr.dtype} — not "
                f"wire-serializable (Text columns must be featurized "
                f"before crossing a transport)")
        arr = np.ascontiguousarray(arr)
        cols.append([name, arr.dtype.str, list(arr.shape)])
        bufs.append(arr.tobytes())
    meta = dict(meta)
    meta["cols"] = cols
    blob = json.dumps(meta, sort_keys=True).encode("utf-8")
    return b"".join([struct.pack("!I", len(blob)), blob] + bufs)


def _decode_arrays(payload: bytes
                   ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    if len(payload) < 4:
        raise WireProtocolError("array payload shorter than its "
                                "meta-length prefix")
    (jlen,) = struct.unpack("!I", payload[:4])
    if len(payload) < 4 + jlen:
        raise WireProtocolError(
            f"truncated payload meta: {len(payload) - 4} of {jlen} "
            f"bytes")
    try:
        meta = json.loads(payload[4:4 + jlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireProtocolError(f"corrupt payload meta: {e}") from None
    if not isinstance(meta, dict) or not isinstance(
            meta.get("cols"), list):
        raise WireProtocolError("payload meta missing 'cols' manifest")
    arrays: Dict[str, np.ndarray] = {}
    off = 4 + jlen
    for entry in meta["cols"]:
        try:
            name, dtype_str, shape = entry
            dtype = np.dtype(dtype_str)
            shape = tuple(int(s) for s in shape)
        except (TypeError, ValueError) as e:
            raise WireProtocolError(
                f"corrupt column manifest entry {entry!r}: {e}"
            ) from None
        nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        if off + nbytes > len(payload):
            raise WireProtocolError(
                f"truncated column {name!r}: need {nbytes} bytes at "
                f"offset {off}, have {len(payload) - off}")
        arrays[name] = np.frombuffer(
            payload[off:off + nbytes], dtype=dtype).reshape(shape).copy()
        off += nbytes
    if off != len(payload):
        raise WireProtocolError(
            f"{len(payload) - off} trailing bytes after last column")
    return meta, arrays


# -- SUBMIT --------------------------------------------------------------

def encode_submit(data, *, deadline_ms: Optional[float] = None,
                  trace: Optional[str] = None, priority: str = "normal",
                  model: Optional[str] = None,
                  tenant: Optional[str] = None) -> bytes:
    """Batch + request envelope (per-request deadline travels ON the
    wire, so the worker's admission controller enforces it too).
    Accepts the same duck-typed data the engine does: a Dataset
    (schema rides as ftype class names) or a mapping of columns."""
    meta: Dict[str, Any] = {"deadline_ms": deadline_ms, "trace": trace,
                            "priority": priority, "model": model,
                            "tenant": tenant}
    if isinstance(data, Dataset):
        meta["kind"] = "dataset"
        meta["schema"] = {name: data.ftype(name).__name__
                          for name in data.column_names}
        arrays = [(name, data.column(name))
                  for name in data.column_names]
    elif hasattr(data, "items"):
        meta["kind"] = "columns"
        arrays = [(str(name), np.asarray(col))
                  for name, col in data.items()]
    else:
        raise TypeError(
            f"wire submit wants a Dataset or a mapping of columns, "
            f"got {type(data).__name__}")
    return _encode_arrays(meta, arrays)


def decode_submit(payload: bytes) -> Tuple[Any, Dict[str, Any]]:
    """``(data, envelope)`` where data is a Dataset or column dict and
    envelope carries deadline_ms/trace/priority/model/tenant."""
    meta, arrays = _decode_arrays(payload)
    if meta.get("kind") == "dataset":
        schema = {}
        for name, tname in (meta.get("schema") or {}).items():
            cls = getattr(ftypes, str(tname), None)
            if not (isinstance(cls, type)
                    and issubclass(cls, ftypes.FeatureType)):
                raise WireProtocolError(
                    f"unknown feature type {tname!r} for column "
                    f"{name!r}")
            schema[name] = cls
        if set(schema) != set(arrays):
            raise WireProtocolError(
                "dataset schema names and column buffers disagree")
        data: Any = Dataset(arrays, schema)
    else:
        data = arrays
    env = {k: meta.get(k) for k in
           ("deadline_ms", "trace", "priority", "model", "tenant")}
    return data, env


# -- RESULT --------------------------------------------------------------

def encode_result(scores: Dict[str, np.ndarray], *,
                  engine_s: Optional[float] = None) -> bytes:
    """Score dict + the worker-side engine time (submit→resolve
    seconds), so the client can attribute RTT − engine_s to the wire
    as the ``transport`` overhead segment."""
    return _encode_arrays({"engine_s": engine_s},
                          sorted(scores.items()))


def decode_result(payload: bytes
                  ) -> Tuple[Dict[str, np.ndarray], Optional[float]]:
    meta, arrays = _decode_arrays(payload)
    engine_s = meta.get("engine_s")
    return arrays, (float(engine_s) if engine_s is not None else None)


# -- ERROR ---------------------------------------------------------------

def encode_error(exc: BaseException) -> bytes:
    retryable = bool(getattr(exc, "retryable", False))
    return json.dumps({"etype": type(exc).__name__,
                       "message": str(exc),
                       "retryable": retryable},
                      sort_keys=True).encode("utf-8")


def decode_error(payload: bytes) -> BaseException:
    """Reconstruct the taxonomy class by name; unknown types degrade
    to :class:`RemoteError` with the sender's retryable verdict."""
    try:
        doc = json.loads(payload.decode("utf-8"))
        etype = str(doc["etype"])
        message = str(doc.get("message", ""))
        retryable = bool(doc.get("retryable", False))
    except (UnicodeDecodeError, json.JSONDecodeError, KeyError,
            TypeError) as e:
        raise WireProtocolError(f"corrupt error frame: {e}") from None
    cls = ERROR_TYPES.get(etype)
    if cls is None:
        return RemoteError(message, retryable=retryable, etype=etype)
    try:
        return cls(message)
    except Exception:
        return RemoteError(f"{etype}: {message}", retryable=retryable,
                           etype=etype)


# -- CONTROL -------------------------------------------------------------

def encode_control(op: str, **args: Any) -> bytes:
    return json.dumps({"op": op, "args": args},
                      sort_keys=True).encode("utf-8")


def decode_control(payload: bytes) -> Tuple[str, Dict[str, Any]]:
    try:
        doc = json.loads(payload.decode("utf-8"))
        op = str(doc["op"])
        args = dict(doc.get("args") or {})
    except (UnicodeDecodeError, json.JSONDecodeError, KeyError,
            TypeError, ValueError) as e:
        raise WireProtocolError(f"corrupt control frame: {e}") from None
    return op, args


def encode_reply(doc: Dict[str, Any]) -> bytes:
    return json.dumps(doc, sort_keys=True).encode("utf-8")


def decode_reply(payload: bytes) -> Dict[str, Any]:
    try:
        doc = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireProtocolError(f"corrupt reply frame: {e}") from None
    if not isinstance(doc, dict):
        raise WireProtocolError("reply frame is not a JSON object")
    return doc


def recv_exactly(sock, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise: ConnectionError on a clean
    EOF at a frame boundary-to-be, WireProtocolError mid-frame."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if got == 0:
                raise ConnectionError("connection closed")
            raise WireProtocolError(
                f"connection closed mid-frame: {got} of {n} bytes")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(sock) -> Tuple[int, int, bytes]:
    """Blocking read of one whole frame off a socket:
    ``(frame_type, correlation_id, payload)``. The payload is crc-
    verified against the header before it is returned — corruption
    surfaces HERE, classified, not as a wrong score downstream."""
    ftype, corr, plen, crc = decode_header(
        recv_exactly(sock, HEADER.size))
    payload = recv_exactly(sock, plen) if plen else b""
    check_crc(payload, crc, ftype)
    return ftype, corr, payload
