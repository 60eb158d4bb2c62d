"""Parquet and Avro readers (the port's copy of
``transmogrifai_tpu/readers/formats.py``).

Reference: readers/src/main/scala/com/salesforce/op/readers/ — the
`AvroReader`/`CSVAutoReader` family reads Avro container files (via
spark-avro) and Parquet through Spark's DataFrameReader; aggregate /
conditional / joined readers then compose over any base reader.

TPU-first design: Parquet lands as Arrow columns (pyarrow) and takes a
columnar fast path straight into the numpy-backed `Dataset` — numeric
columns never materialize per-row Python objects, mirroring the native
CSV fast path. Avro has no wheel in this image, so the Object Container
File format (null + deflate codecs) is decoded by a small pure-Python
binary reader below; a matching writer exists for fixtures and export.
Both readers plug into the same `DataReader` contract, so
AggregateDataReader / ConditionalDataReader / JoinedDataReader work over
them unchanged.
"""
from __future__ import annotations

import calendar
import datetime as _dt
import io
import json
import os
import struct
import zlib
from typing import (Any, Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple, Type)

import numpy as np

from ..dataset import Dataset, column_to_numpy
from ..features import types as ft
from ..features.feature import Feature
from .core import DataReader, _infer_column_type


# ---------------------------------------------------------------------------
# Parquet (pyarrow-backed)
# ---------------------------------------------------------------------------

def _epoch_millis(v) -> int:
    """datetime/date -> epoch millis, timezone-stable: naive values are
    read as UTC wall-clock (calendar.timegm), never the host's local TZ,
    so features derived from the same file agree across machines."""
    if isinstance(v, _dt.datetime):
        if v.tzinfo is not None:
            return int(v.timestamp() * 1000)
        return calendar.timegm(v.timetuple()) * 1000 + v.microsecond // 1000
    return calendar.timegm(v.timetuple()) * 1000     # datetime.date


def _arrow_feature_type(pa_type) -> Type[ft.FeatureType]:
    """Map an Arrow dtype to the canonical FeatureType wrapper."""
    import pyarrow as pa
    if pa.types.is_boolean(pa_type):
        return ft.Binary
    if pa.types.is_integer(pa_type):
        return ft.Integral
    if pa.types.is_floating(pa_type) or pa.types.is_decimal(pa_type):
        return ft.Real
    if pa.types.is_timestamp(pa_type) or pa.types.is_date(pa_type):
        return ft.DateTime
    if pa.types.is_list(pa_type) or pa.types.is_large_list(pa_type):
        item = pa_type.value_type
        if pa.types.is_floating(item):
            return ft.Geolocation
        if pa.types.is_integer(item):
            return ft.DateList
        return ft.TextList
    if pa.types.is_map(pa_type) or pa.types.is_struct(pa_type):
        return ft.TextMap
    return ft.Text


def infer_parquet_schema(path: str, picklist_max_card: int = 50,
                         sample_rows: int = 1000
                         ) -> Dict[str, Type[ft.FeatureType]]:
    """Arrow schema -> FeatureType schema. String columns are sampled and
    promoted to PickList/Email/etc. with the same heuristics as CSV auto
    inference (reference: CSVAutoReader schema inference)."""
    import pyarrow.parquet as pq
    pf = pq.ParquetFile(path)
    arrow_schema = pf.schema_arrow
    schema: Dict[str, Type[ft.FeatureType]] = {}
    string_cols = [f.name for f in arrow_schema
                   if _arrow_feature_type(f.type) is ft.Text]
    sampled: Dict[str, List[str]] = {}
    if string_cols:
        head = next(pf.iter_batches(batch_size=sample_rows,
                                    columns=string_cols), None)
        if head is not None:
            for name in string_cols:
                sampled[name] = [v for v in head.column(name).to_pylist()
                                 if v is not None]
    for field in arrow_schema:
        wtype = _arrow_feature_type(field.type)
        if wtype is ft.Text:
            vals = sampled.get(field.name, [])
            wtype = _infer_column_type([str(v) for v in vals],
                                       picklist_max_card) if vals else ft.Text
        schema[field.name] = wtype
    return schema


class ParquetProductReader(DataReader):
    """Parquet -> typed records under a declared FeatureType schema.

    `generate_dataset` takes a columnar fast path: Arrow numeric columns
    convert to the Dataset's float64 blocks via zero-copy-ish
    `to_numpy`, skipping per-row Python dicts entirely (same plan
    precondition as the native CSV path: plain same-named column
    features with no aggregator).
    """

    def __init__(self, path: str, schema: Mapping[str, Type[ft.FeatureType]],
                 key=None, columns: Optional[Sequence[str]] = None):
        super().__init__(records=None, key=key)
        self.path = path
        self.schema = dict(schema)
        self.columns = list(columns) if columns is not None else None

    def _table(self):
        import pyarrow.parquet as pq
        return pq.read_table(self.path, columns=self.columns)

    def read(self) -> List[Dict[str, Any]]:
        table = self._table()
        unknown = [n for n in table.column_names if n not in self.schema]
        if unknown:
            raise ValueError(f"Parquet columns not in schema: {unknown}")
        cols = {n: self._pycolumn(table.column(n), self.schema[n])
                for n in table.column_names}
        names = list(cols)
        return [{n: cols[n][i] for n in names} for i in range(table.num_rows)]

    @staticmethod
    def _pycolumn(col, wtype: Type[ft.FeatureType]) -> List[Any]:
        vals = col.to_pylist()
        if issubclass(wtype, ft.Binary):
            return [None if v is None else bool(v) for v in vals]
        if issubclass(wtype, ft.OPNumeric):   # incl. Integral/Date/DateTime
            cast = int if issubclass(wtype, ft.Integral) else float
            out = []
            for v in vals:
                if v is None:
                    out.append(None)
                elif isinstance(v, (_dt.datetime, _dt.date)):
                    out.append(_epoch_millis(v))
                else:
                    out.append(cast(v))
            return out
        if issubclass(wtype, ft.OPMap):
            return [None if v is None else dict(v) for v in vals]
        if issubclass(wtype, (ft.OPList, ft.OPSet)):
            return [None if v is None else list(v) for v in vals]
        return [None if v is None else str(v) for v in vals]

    def generate_dataset(self, features) -> Dataset:
        fast = self._columnar_dataset(features)
        if fast is not None:
            return fast
        return super().generate_dataset(features)

    def _columnar_dataset(self, features) -> Optional[Dataset]:
        from ..stages.generator import FeatureGeneratorStage
        for f in features:
            st = f.origin_stage
            if not (isinstance(st, FeatureGeneratorStage)
                    and st.aggregator is None
                    and getattr(st.extract_fn, "column_name", None) == f.name
                    and f.name in self.schema):
                return None
        table = self._table()
        out_cols: Dict[str, np.ndarray] = {}
        schema: Dict[str, Any] = {}
        for f in features:
            if f.name not in table.column_names:
                return None
            col = table.column(f.name)
            if (issubclass(f.wtype, ft.OPNumeric)
                    and not issubclass(f.wtype, ft.Binary)
                    and str(col.type) in ("float", "double", "int8", "int16",
                                          "int32", "int64", "uint8", "uint16",
                                          "uint32", "uint64")):
                arr = col.to_numpy(zero_copy_only=False).astype(np.float64)
                out_cols[f.name] = arr
            else:
                out_cols[f.name] = column_to_numpy(
                    self._pycolumn(col, f.wtype), f.wtype)
            schema[f.name] = f.wtype
        return Dataset(out_cols, schema)


class ParquetAutoReader(ParquetProductReader):
    """Parquet with FeatureType schema inferred from the Arrow schema."""

    def __init__(self, path: str, key=None, **infer_kw):
        super().__init__(path, infer_parquet_schema(path, **infer_kw), key=key)


# ---------------------------------------------------------------------------
# Avro Object Container Files (pure-Python codec; reference: AvroReader)
# ---------------------------------------------------------------------------

_MAGIC = b"Obj\x01"


class _BinaryDecoder:
    """Avro binary decoding primitives (spec: Apache Avro 1.11 binary)."""

    def __init__(self, buf: bytes):
        self._io = io.BytesIO(buf)

    def read(self, n: int) -> bytes:
        out = self._io.read(n)
        if len(out) != n:
            raise EOFError("truncated Avro data")
        return out

    def long(self) -> int:
        shift, acc = 0, 0
        while True:
            b = self.read(1)[0]
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)          # zig-zag

    def boolean(self) -> bool:
        return self.read(1) != b"\x00"

    def float_(self) -> float:
        return struct.unpack("<f", self.read(4))[0]

    def double(self) -> float:
        return struct.unpack("<d", self.read(8))[0]

    def bytes_(self) -> bytes:
        return self.read(self.long())

    def string(self) -> str:
        return self.bytes_().decode("utf-8")

    def at_end(self) -> bool:
        here = self._io.tell()
        more = self._io.read(1)
        self._io.seek(here)
        return more == b""


class _BinaryEncoder:
    def __init__(self):
        self._io = io.BytesIO()

    def value(self) -> bytes:
        return self._io.getvalue()

    def long(self, v: int) -> None:
        v = (v << 1) ^ (v >> 63)                # zig-zag (64-bit)
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self._io.write(bytes([b | 0x80]))
            else:
                self._io.write(bytes([b]))
                break

    def boolean(self, v: bool) -> None:
        self._io.write(b"\x01" if v else b"\x00")

    def double(self, v: float) -> None:
        self._io.write(struct.pack("<d", v))

    def bytes_(self, v: bytes) -> None:
        self.long(len(v))
        self._io.write(v)

    def string(self, v: str) -> None:
        self.bytes_(v.encode("utf-8"))


def _decode_value(dec: _BinaryDecoder, schema: Any) -> Any:
    """Decode one value per the (already JSON-parsed) Avro schema."""
    if isinstance(schema, list):                # union: branch index then value
        return _decode_value(dec, schema[dec.long()])
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            return {f["name"]: _decode_value(dec, f["type"])
                    for f in schema["fields"]}
        if t == "enum":
            return schema["symbols"][dec.long()]
        if t == "fixed":
            return dec.read(schema["size"])
        if t == "array":
            out = []
            while True:
                count = dec.long()
                if count == 0:
                    break
                if count < 0:                   # block with byte size prefix
                    count = -count
                    dec.long()
                for _ in range(count):
                    out.append(_decode_value(dec, schema["items"]))
            return out
        if t == "map":
            out = {}
            while True:
                count = dec.long()
                if count == 0:
                    break
                if count < 0:
                    count = -count
                    dec.long()
                for _ in range(count):
                    k = dec.string()    # key MUST read before the value
                    out[k] = _decode_value(dec, schema["values"])
            return out
        return _decode_value(dec, t)            # logical type / named alias
    if schema == "null":
        return None
    if schema == "boolean":
        return dec.boolean()
    if schema in ("int", "long"):
        return dec.long()
    if schema == "float":
        return dec.float_()
    if schema == "double":
        return dec.double()
    if schema == "bytes":
        return dec.bytes_()
    if schema == "string":
        return dec.string()
    raise ValueError(f"unsupported Avro type {schema!r}")


# -- reader-vs-writer schema resolution (Avro spec "Schema Resolution";
#    spark-avro gives the reference's AvroReader this for free) ----------

#: writer primitive -> reader primitives it may promote to
_PROMOTIONS = {
    "null": ("null",), "boolean": ("boolean",),
    "int": ("int", "long", "float", "double"),
    "long": ("long", "float", "double"),
    "float": ("float", "double"), "double": ("double",),
    "string": ("string", "bytes"), "bytes": ("bytes", "string"),
}


def _unwrap(s: Any) -> Any:
    """Strip logical-type wrappers ({'type': 'int', 'logicalType': ...})
    down to the primitive; named/complex dicts pass through."""
    while (isinstance(s, dict)
           and s["type"] not in ("record", "enum", "fixed", "array", "map")):
        s = s["type"]
    return s


def _schema_names(s: Any) -> Tuple[str, ...]:
    """(name, *aliases) of a named schema, unqualified (spec: a reader
    alias matches the writer's full OR unqualified name)."""
    short = s.get("name", "").rsplit(".", 1)[-1]
    return (short,) + tuple(a.rsplit(".", 1)[-1]
                            for a in s.get("aliases", ()))


def _resolvable(w: Any, r: Any) -> bool:
    """Cheap compatibility test used for union-branch selection."""
    w, r = _unwrap(w), _unwrap(r)
    if isinstance(r, list):
        return any(_resolvable(w, b) for b in r)
    if isinstance(w, list):
        return True     # per-value branch resolution happens at decode
    if isinstance(w, dict) and isinstance(r, dict):
        if w["type"] != r["type"]:
            return False
        if w["type"] in ("record", "enum", "fixed"):
            return bool(set(_schema_names(w)) & set(_schema_names(r)))
        return True
    if isinstance(w, str) and isinstance(r, str):
        return r in _PROMOTIONS.get(w, ())
    return False


def _json_default(default: Any, schema: Any) -> Any:
    """A reader field's JSON default -> decoded-value form."""
    s = _unwrap(schema)
    if isinstance(s, list):          # union default uses the FIRST branch
        return _json_default(default, s[0])
    if isinstance(s, dict):
        t = s["type"]
        if t == "record":
            # the field's own JSON default object wins per subfield; a
            # subfield it omits falls back to that subfield's default
            d = default or {}
            return {f["name"]: _json_default(
                        d.get(f["name"], f.get("default")), f["type"])
                    for f in s["fields"]}
        if t == "array":
            return [_json_default(v, s["items"]) for v in (default or [])]
        if t == "map":
            return {k: _json_default(v, s["values"])
                    for k, v in (default or {}).items()}
        if t == "fixed":
            return default.encode("latin-1")
        return default               # enum symbol
    if s == "bytes":                 # spec: bytes defaults are latin-1 text
        return default.encode("latin-1")
    if s in ("float", "double") and default is not None:
        return float(default)
    return default


def _resolve_value(dec: _BinaryDecoder, writer: Any, reader: Any) -> Any:
    """Decode one value written as `writer`, resolved into `reader`
    (promotions, field defaults, aliases, union re-branching)."""
    writer, reader = _unwrap(writer), _unwrap(reader)
    if isinstance(writer, list):                # writer union: real branch
        return _resolve_value(dec, writer[dec.long()], reader)
    if isinstance(reader, list):                # reader union: first match
        for b in reader:
            if _resolvable(writer, b):
                return _resolve_value(dec, writer, b)
        raise ValueError(f"no reader union branch in {reader!r} "
                         f"resolves writer schema {writer!r}")
    if isinstance(writer, dict) and isinstance(reader, dict):
        wt, rt = writer["type"], reader["type"]
        if wt != rt:
            raise ValueError(f"cannot resolve writer {wt} into reader {rt}")
        if wt in ("record", "enum", "fixed") and not (
                set(_schema_names(writer)) & set(_schema_names(reader))):
            raise ValueError(
                f"writer {wt} {writer.get('name')!r} does not match reader "
                f"{reader.get('name')!r} or its aliases")
        if wt == "record":
            # reader field name OR alias -> reader field
            by_name: Dict[str, Any] = {}
            for f in reader["fields"]:
                by_name[f["name"]] = f
                for a in f.get("aliases", ()):
                    by_name[a] = f
            out, seen = {}, set()
            for wf in writer["fields"]:
                rf = by_name.get(wf["name"])
                if rf is None:      # writer-only field: decode + discard
                    _decode_value(dec, wf["type"])
                else:
                    out[rf["name"]] = _resolve_value(
                        dec, wf["type"], rf["type"])
                    seen.add(rf["name"])
            for rf in reader["fields"]:
                if rf["name"] not in seen:
                    if "default" not in rf:
                        raise ValueError(
                            f"reader field {rf['name']!r} missing from "
                            f"writer data and has no default")
                    out[rf["name"]] = _json_default(rf["default"],
                                                    rf["type"])
            return out
        if wt == "enum":
            sym = writer["symbols"][dec.long()]
            if sym in reader["symbols"]:
                return sym
            if "default" in reader:
                return reader["default"]
            raise ValueError(f"enum symbol {sym!r} absent from reader "
                             f"{reader.get('name')!r} (no default)")
        if wt == "fixed":
            if writer["size"] != reader["size"]:
                raise ValueError(
                    f"fixed size mismatch {writer['size']} != "
                    f"{reader['size']} for {reader.get('name')!r}")
            return dec.read(writer["size"])
        if wt == "array":
            out_l: List[Any] = []
            while True:
                count = dec.long()
                if count == 0:
                    break
                if count < 0:
                    count = -count
                    dec.long()
                for _ in range(count):
                    out_l.append(_resolve_value(dec, writer["items"],
                                                reader["items"]))
            return out_l
        if wt == "map":
            out_m: Dict[str, Any] = {}
            while True:
                count = dec.long()
                if count == 0:
                    break
                if count < 0:
                    count = -count
                    dec.long()
                for _ in range(count):
                    k = dec.string()
                    out_m[k] = _resolve_value(dec, writer["values"],
                                              reader["values"])
            return out_m
        raise ValueError(f"unsupported Avro type {writer!r}")
    # primitives (with promotion)
    if not (isinstance(writer, str) and isinstance(reader, str)
            and reader in _PROMOTIONS.get(writer, ())):
        raise ValueError(f"cannot resolve writer schema {writer!r} "
                         f"into reader schema {reader!r}")
    v = _decode_value(dec, writer)
    if reader in ("float", "double") and v is not None:
        return float(v)
    if writer == "string" and reader == "bytes":
        return v.encode("utf-8")
    if writer == "bytes" and reader == "string":
        return v.decode("utf-8")
    return v


def _branch_matches(s: Any, v: Any) -> bool:
    if isinstance(s, dict):
        t = s["type"]
        return ((t == "record" and isinstance(v, dict))
                or (t == "enum" and isinstance(v, str))
                or (t == "array" and isinstance(v, (list, tuple)))
                or (t == "map" and isinstance(v, dict))
                or (t == "fixed" and isinstance(v, (bytes, bytearray))))
    if s == "boolean":
        return isinstance(v, bool)
    if s in ("int", "long"):
        return isinstance(v, int) and not isinstance(v, bool)
    if s in ("float", "double"):
        return isinstance(v, float)
    if s == "bytes":
        return isinstance(v, (bytes, bytearray))
    if s == "string":
        return isinstance(v, str)
    return False


def _encode_value(enc: _BinaryEncoder, schema: Any, v: Any) -> None:
    if isinstance(schema, list):
        if v is None:
            enc.long(schema.index("null"))
            return
        # pick the branch whose Avro type matches the value's python type;
        # encoding into the first non-null branch would silently coerce
        for i, s in enumerate(schema):
            if s != "null" and _branch_matches(s, v):
                enc.long(i)
                _encode_value(enc, s, v)
                return
        raise ValueError(f"no union branch in {schema!r} matches "
                         f"{type(v).__name__} value {v!r}")
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            for f in schema["fields"]:
                _encode_value(enc, f["type"], v[f["name"]])
            return
        if t == "array":
            if v:
                enc.long(len(v))
                for item in v:
                    _encode_value(enc, schema["items"], item)
            enc.long(0)
            return
        if t == "map":
            if v:
                enc.long(len(v))
                for k, item in v.items():
                    enc.string(str(k))
                    _encode_value(enc, schema["values"], item)
            enc.long(0)
            return
        if t == "enum":
            enc.long(schema["symbols"].index(v))
            return
        if t == "fixed":
            enc._io.write(bytes(v))
            return
        _encode_value(enc, t, v)
        return
    if schema == "null":
        return
    if schema == "boolean":
        enc.boolean(bool(v))
    elif schema in ("int", "long"):
        enc.long(int(v))
    elif schema == "double":
        enc.double(float(v))
    elif schema == "float":
        enc._io.write(struct.pack("<f", float(v)))
    elif schema == "bytes":
        enc.bytes_(bytes(v))
    elif schema == "string":
        enc.string(str(v))
    else:
        raise ValueError(f"unsupported Avro type {schema!r}")


def _snappy_decompress(data: bytes) -> bytes:
    """Pure-Python snappy RAW-format decompressor (the Avro `snappy`
    codec's block format; reference reads it via spark-avro + JNI
    snappy). Format: uvarint uncompressed length, then literal/copy
    tags; copies may overlap and run byte-by-byte. Raises ValueError on
    ANY malformed input — truncation included."""
    try:
        return _snappy_decompress_inner(data)
    except IndexError:
        raise ValueError("snappy: truncated input") from None


def _snappy_decompress_inner(data: bytes) -> bytes:
    if not data:
        raise ValueError("snappy: empty input")
    # uvarint preamble
    n = shift = pos = 0
    while True:
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    ln = len(data)
    while pos < ln:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                                 # literal
            size = tag >> 2
            if size >= 60:                            # length in next bytes
                nb = size - 59
                size = int.from_bytes(data[pos:pos + nb], "little")
                pos += nb
            size += 1
            out += data[pos:pos + size]
            pos += size
            continue
        if kind == 1:                                 # copy, 1-byte offset
            size = ((tag >> 2) & 7) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:                               # copy, 2-byte offset
            size = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:                                         # copy, 4-byte offset
            size = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("snappy: invalid copy offset")
        start = len(out) - offset
        if offset >= size:                            # non-overlapping
            out += out[start:start + size]
        else:                                         # overlapping run
            for i in range(size):
                out.append(out[start + i])
    if len(out) != n:
        raise ValueError(f"snappy: declared {n} bytes, got {len(out)}")
    return bytes(out)


def _snappy_compress(data: bytes) -> bytes:
    """Literal-only snappy encoder (spec-valid output, no compression —
    enough for write_avro fixtures; readers including this one and JNI
    snappy decode it)."""
    out = bytearray()
    n = len(data)
    v = n
    while True:                                       # uvarint length
        if v < 0x80:
            out.append(v)
            break
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    pos = 0
    while pos < n:                                    # 2^16-byte literals
        chunk = data[pos:pos + 65536]
        size = len(chunk) - 1
        if size < 60:
            out.append(size << 2)
        else:
            nb = (size.bit_length() + 7) // 8
            out.append((59 + nb) << 2)
            out += size.to_bytes(nb, "little")
        out += chunk
        pos += len(chunk)
    return bytes(out)


def read_avro(path: str, max_records: Optional[int] = None,
              reader_schema: Any = None) -> Tuple[Any, List[Any]]:
    """Read an Avro Object Container File -> (schema, records).
    Codecs: null, deflate (raw RFC-1951), snappy (raw block format +
    4-byte big-endian CRC32 of the uncompressed data, per the Avro
    spec). `max_records` stops decoding once that many records are read
    (schema-only peeks use max_records=0). A `reader_schema` resolves
    the file's writer schema per the Avro spec (field defaults, aliases,
    int->long/float->double-style promotions, union re-branching) — the
    evolution surface spark-avro gives the reference's AvroReader; the
    returned schema is then the READER schema the records conform to."""
    with open(path, "rb") as fh:
        data = fh.read()
    dec = _BinaryDecoder(data)
    if dec.read(4) != _MAGIC:
        raise ValueError(f"{path}: not an Avro object container file")
    meta_schema = {"type": "map", "values": "bytes"}
    meta = _decode_value(dec, meta_schema)
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null")
    codec = codec.decode() if isinstance(codec, bytes) else codec
    if codec not in ("null", "deflate", "snappy"):
        raise ValueError(f"unsupported Avro codec {codec!r}")
    sync = dec.read(16)
    records: List[Any] = []
    while not dec.at_end():
        if max_records is not None and len(records) >= max_records:
            break
        count = dec.long()
        block = dec.bytes_()
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        elif codec == "snappy":
            comp, crc = block[:-4], block[-4:]
            block = _snappy_decompress(comp)
            if zlib.crc32(block) & 0xFFFFFFFF != int.from_bytes(crc, "big"):
                raise ValueError(f"{path}: Avro snappy block CRC mismatch")
        bdec = _BinaryDecoder(block)
        for _ in range(count):
            if reader_schema is not None:
                records.append(_resolve_value(bdec, schema, reader_schema))
            else:
                records.append(_decode_value(bdec, schema))
            if max_records is not None and len(records) >= max_records:
                break
        if dec.read(16) != sync:
            raise ValueError(f"{path}: bad Avro sync marker")
    return (schema if reader_schema is None else reader_schema), records


def write_avro(path: str, schema: Any, records: Iterable[Any],
               codec: str = "deflate") -> None:
    """Write an Avro Object Container File (fixtures, Features export)."""
    if codec not in ("null", "deflate", "snappy"):
        raise ValueError(f"unsupported Avro codec {codec!r}")
    enc = _BinaryEncoder()
    enc._io.write(_MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode()}
    _encode_value(enc, {"type": "map", "values": "bytes"}, meta)
    sync = b"\x00\x01\x02\x03\x04\x05\x06\x07TMOGSYNC"
    enc._io.write(sync)
    records = list(records)
    if records:
        body = _BinaryEncoder()
        for r in records:
            _encode_value(body, schema, r)
        block = body.value()
        if codec == "deflate":
            comp = zlib.compressobj(9, zlib.DEFLATED, -15)
            block = comp.compress(block) + comp.flush()
        elif codec == "snappy":
            block = (_snappy_compress(block)
                     + (zlib.crc32(block) & 0xFFFFFFFF).to_bytes(4, "big"))
        enc.long(len(records))
        enc.bytes_(block)
        enc._io.write(sync)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(enc.value())
    os.replace(tmp, path)


def _avro_feature_type(schema: Any) -> Type[ft.FeatureType]:
    if isinstance(schema, list):                # optional union
        non_null = [s for s in schema if s != "null"]
        return _avro_feature_type(non_null[0]) if non_null else ft.Text
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "array":
            item = _avro_feature_type(schema["items"])
            if issubclass(item, ft.Integral):
                return ft.DateList
            if issubclass(item, ft.OPNumeric):
                return ft.Geolocation
            return ft.TextList
        if t == "map":
            v = _avro_feature_type(schema["values"])
            if issubclass(v, ft.Binary):
                return ft.BinaryMap
            if issubclass(v, ft.Integral):
                return ft.IntegralMap
            if issubclass(v, ft.OPNumeric):
                return ft.RealMap
            return ft.TextMap
        if t == "enum":
            return ft.PickList
        return _avro_feature_type(t)
    return {"boolean": ft.Binary, "int": ft.Integral, "long": ft.Integral,
            "float": ft.Real, "double": ft.Real, "bytes": ft.Base64,
            "string": ft.Text}.get(schema, ft.Text)


def infer_avro_schema(avro_schema: Any) -> Dict[str, Type[ft.FeatureType]]:
    """Avro record schema -> FeatureType schema (CLI + AutoReader use)."""
    if not (isinstance(avro_schema, dict) and avro_schema.get("type") == "record"):
        raise ValueError("top-level Avro schema must be a record")
    return {f["name"]: _avro_feature_type(f["type"])
            for f in avro_schema["fields"]}


class AvroReader(DataReader):
    """Avro container file -> typed records.

    The FeatureType schema derives from the file's embedded Avro schema
    unless explicitly declared. Aggregate/conditional/joined readers
    compose over this like any DataReader.
    """

    def __init__(self, path: str,
                 schema: Optional[Mapping[str, Type[ft.FeatureType]]] = None,
                 key=None, reader_schema: Any = None):
        super().__init__(records=None, key=key)
        self.path = path
        self._declared = dict(schema) if schema is not None else None
        self._avro_schema: Optional[Any] = None
        # an app-declared Avro READER schema: files written under any
        # resolvable older/newer writer schema decode into this shape
        self._reader_schema = reader_schema

    @property
    def schema(self) -> Dict[str, Type[ft.FeatureType]]:
        if self._declared is not None:
            return self._declared
        if self._avro_schema is None:
            self._avro_schema, self._cached = read_avro(
                self.path, reader_schema=self._reader_schema)
        self._declared = infer_avro_schema(self._avro_schema)
        return self._declared

    def read(self) -> List[Dict[str, Any]]:
        if getattr(self, "_cached", None) is None:
            self._avro_schema, self._cached = read_avro(
                self.path, reader_schema=self._reader_schema)
        out = []
        for rec in self._cached:
            row = dict(rec)
            for k, v in row.items():
                if isinstance(v, bytes):        # Base64 columns stay str-like
                    import base64
                    row[k] = base64.b64encode(v).decode("ascii")
            out.append(row)
        return out
