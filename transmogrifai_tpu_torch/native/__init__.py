"""ctypes bindings for the native runtime (csrc/libtmnative.so) (the port's copy of
``transmogrifai_tpu/native/__init__.py``).

Native-parity layer: the reference's hot host-side paths (CSV ingest,
MurmurHash3) ride C/C++ through the JVM (Hadoop native IO, Spark
HashingTF); here the same paths ride a small C++ library. The library is
built on demand with `make` (g++) the first time it's needed; every
entry point has a pure-Python fallback so the framework works without a
toolchain.

API:
- available() -> bool
- load_csv_columns(path, delimiter) -> (header, {name: ndarray|list})
  numeric-looking columns come back as float64 arrays (NaN = null);
  other columns as Python string lists ('' = empty cell).
- murmur3_batch(tokens, n_bins, seed) -> int32 ndarray (bit-identical
  to ops.hashing.hash_string).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

_CSRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc")
_LIB_PATH = os.path.abspath(os.path.join(_CSRC, "libtmnative.so"))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        r = subprocess.run(["make", "-C", os.path.abspath(_CSRC)],
                           capture_output=True, text=True, timeout=120)
        return r.returncode == 0 and os.path.exists(_LIB_PATH)
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        # always invoke make: a no-op when the .so is current, a rebuild
        # when csrc/ gained entry points since the last build
        if not _build() and not os.path.exists(_LIB_PATH):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.tm_csv_open.restype = ctypes.c_void_p
        lib.tm_csv_open.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                    ctypes.c_int]
        if hasattr(lib, "tm_csv_open_mem"):
            lib.tm_csv_open_mem.restype = ctypes.c_void_p
            lib.tm_csv_open_mem.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_char,
                ctypes.c_int]
            lib.tm_csv_last_record_end.restype = ctypes.c_int64
            lib.tm_csv_last_record_end.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_char]
        lib.tm_csv_ncols.restype = ctypes.c_int
        lib.tm_csv_ncols.argtypes = [ctypes.c_void_p]
        lib.tm_csv_nrows.restype = ctypes.c_int64
        lib.tm_csv_nrows.argtypes = [ctypes.c_void_p]
        lib.tm_csv_header.restype = ctypes.c_char_p
        lib.tm_csv_header.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tm_csv_numeric_col.restype = ctypes.c_int64
        lib.tm_csv_numeric_col.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
        lib.tm_csv_col_bytes.restype = ctypes.c_int64
        lib.tm_csv_col_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tm_csv_string_col.restype = None
        lib.tm_csv_string_col.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
        lib.tm_csv_close.restype = None
        lib.tm_csv_close.argtypes = [ctypes.c_void_p]
        lib.tm_murmur3_batch.restype = None
        lib.tm_murmur3_batch.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
        if hasattr(lib, "tm_hash_count_rows"):
            lib.tm_hash_count_rows.restype = None
            lib.tm_hash_count_rows.argtypes = [
                ctypes.c_char_p,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.c_int, ctypes.c_int,
                np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def load_csv_columns(path: str, delimiter: str = ",",
                     numeric_cols: Optional[Sequence[str]] = None
                     ) -> Tuple[List[str], Dict[str, Union[np.ndarray,
                                                           List[str]]]]:
    """Parse a whole CSV natively into columns. Raises RuntimeError when
    the native library is unavailable (callers choose their fallback).

    `numeric_cols` names the columns to parse straight to float64 (NaN =
    null); all others come back as string lists so declared-categorical
    numerals keep their original text. With no hint, numeric parsing is
    attempted everywhere and falls back per-column on any bad cell."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    h = lib.tm_csv_open(path.encode(), delimiter.encode()[:1], 1)
    if not h:
        raise IOError(f"cannot open/parse {path}")
    try:
        return _extract_columns(lib, h, numeric_cols)
    finally:
        lib.tm_csv_close(h)


def _extract_columns(lib, h, numeric_cols, header_override=None):
    numeric = None if numeric_cols is None else set(numeric_cols)
    ncols = lib.tm_csv_ncols(h)
    nrows = lib.tm_csv_nrows(h)
    header = (list(header_override) if header_override is not None
              else [lib.tm_csv_header(h, c).decode() for c in range(ncols)])
    cols: Dict[str, Union[np.ndarray, List[str]]] = {}
    for c, name in enumerate(header):
        if c >= ncols:
            # a block whose rows are ALL short never materializes the
            # trailing columns C-side; pad like the whole-file loader
            # pads ragged rows (empty cell = null)
            cols[name] = (np.full(nrows, np.nan)
                          if numeric is None or name in numeric
                          else [""] * nrows)
            continue
        if numeric is None or name in numeric:
            num = np.empty(nrows, dtype=np.float64)
            bad = lib.tm_csv_numeric_col(h, c, num)
            if bad == 0:
                cols[name] = num
                continue
            if numeric is not None:
                raise ValueError(
                    f"column {name!r}: {bad} non-numeric cells but "
                    f"declared numeric")
        nbytes = lib.tm_csv_col_bytes(h, c)
        buf = ctypes.create_string_buffer(max(int(nbytes), 1))
        offs = np.empty(nrows + 1, dtype=np.int64)
        lib.tm_csv_string_col(h, c, buf, offs)
        raw = buf.raw[:nbytes]
        cols[name] = [raw[offs[i]:offs[i + 1]].decode("utf-8", "replace")
                      for i in range(nrows)]
    return header, cols


def parse_csv_bytes(data: bytes, delimiter: str = ",",
                    has_header: bool = True,
                    numeric_cols: Optional[Sequence[str]] = None,
                    header: Optional[Sequence[str]] = None
                    ) -> Tuple[List[str], Dict[str, Union[np.ndarray,
                                                          List[str]]]]:
    """Parse an in-memory CSV block natively (the streaming block
    reader's workhorse — io/stream.csv_chunks_native). Headerless blocks
    map columns positionally onto the caller-supplied `header`."""
    lib = _load()
    if lib is None or not hasattr(lib, "tm_csv_open_mem"):
        raise RuntimeError("native library unavailable")
    h = lib.tm_csv_open_mem(data, len(data), delimiter.encode()[:1],
                            1 if has_header else 0)
    if not h:
        raise IOError("cannot parse CSV block")
    try:
        return _extract_columns(lib, h, numeric_cols,
                                header_override=header)
    finally:
        lib.tm_csv_close(h)


def csv_last_record_end(data: bytes, delimiter: str = ",") -> int:
    """Byte offset just past the last COMPLETE record (quote-aware); 0
    when the buffer holds no complete record."""
    lib = _load()
    if lib is None or not hasattr(lib, "tm_csv_last_record_end"):
        raise RuntimeError("native library unavailable")
    return int(lib.tm_csv_last_record_end(data, len(data),
                                          delimiter.encode()[:1]))


def murmur3_batch(tokens: Sequence[str], n_bins: int, seed: int = 42
                  ) -> np.ndarray:
    """Hash tokens to bins; bit-identical to ops.hashing.hash_string.
    Falls back to the pure-Python hash when the library is missing."""
    lib = _load()
    if lib is None:
        from ..ops.hashing import hash_string
        return np.array([hash_string(t, n_bins, seed) for t in tokens],
                        dtype=np.int32)
    enc = [t.encode("utf-8") for t in tokens]
    offs = np.zeros(len(enc) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    buf = b"".join(enc)
    out = np.empty(len(enc), dtype=np.int32)
    if len(enc):
        lib.tm_murmur3_batch(buf, offs, len(enc), seed & 0xFFFFFFFF,
                             n_bins, out)
    return out


def hash_count_rows(texts: Sequence[Optional[str]], n_bins: int,
                    seed: int = 42, binary: bool = False,
                    min_token_len: int = 1
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize+hash-count whole text cells natively (the hashing-trick
    vectorizer hot loop). Returns (counts (n, n_bins) float64, fallback
    (n,) bool) — rows flagged in `fallback` (non-ASCII cells, or None)
    were left zero for the caller's exact-parity Python path. Raises
    RuntimeError when the native library lacks the entry point."""
    lib = _load()
    if lib is None or not hasattr(lib, "tm_hash_count_rows"):
        raise RuntimeError("native hash_count_rows unavailable")
    n = len(texts)
    encoded: List[bytes] = []
    none_rows = np.zeros(n, dtype=bool)
    for i, t in enumerate(texts):
        if t is None:
            none_rows[i] = True
            encoded.append(b"")
        else:
            encoded.append(t.encode("utf-8"))
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(b) for b in encoded], out=offs[1:])
    buf = b"".join(encoded)
    out = np.zeros((n, n_bins), dtype=np.float64)
    fb = np.zeros(n, dtype=np.uint8)
    lib.tm_hash_count_rows(buf, offs, n, seed & 0xFFFFFFFF, n_bins,
                           int(binary), int(min_token_len), out, fb)
    fallback = fb.astype(bool) | none_rows
    return out, fallback
