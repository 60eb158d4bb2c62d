"""Sparse hashed-feature path for high-cardinality categoricals (Criteo);
the port's copy of ``transmogrifai_tpu/ops/sparse.py`` (host code).

Reference: core/.../stages/impl/feature/OPCollectionHashingVectorizer.scala
and SmartTextVectorizer.scala's hashing branch — the reference hashes
"fieldName_value" into a shared MurmurHash3 space and emits a Spark sparse
vector per row. At Criteo scale the TPU port must NOT materialize a dense
(n, buckets) block: each categorical column contributes exactly ONE int32
index per row into the shared hash space, and the model kernels consume
the (n, K) index matrix directly with gathers / segment-sums
(models/sparse.py). Hashing runs on host via the native murmur3 batch
(csrc/tmnative.cpp) with a pure-python fallback — bit-identical either way
so persisted models score identically forever.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..dataset import Dataset
from ..features import types as ft
from ..stages.base import SequenceTransformer
from .hashing import murmur3_32


def _token(name: str, v: Any) -> str:
    if v is None or (isinstance(v, str) and v == ""):
        return f"{name}|__null__"
    return f"{name}|{v}"


def hash_tokens(tokens: Sequence[str], n_buckets: int, seed: int) -> np.ndarray:
    """Batch murmur3 -> bucket ids; native fast path when built."""
    try:
        from ..native import murmur3_batch
        out = murmur3_batch(tokens, n_buckets, seed)
        if out is not None:
            return out.astype(np.int32)
    except Exception:
        pass
    return np.asarray([murmur3_32(t.encode("utf-8"), seed) % n_buckets
                       for t in tokens], dtype=np.int32)


def _hash_column(col: np.ndarray, name: str, n_buckets: int,
                 seed: int) -> np.ndarray:
    """Whole-column token hashing with unique-value dedup.

    Bit-identical to hashing `_token(name, v)` per row, but the
    Python-level token build + murmur crossing happens once per UNIQUE
    value instead of once per row — categoricals worth hashing have
    cardinality far below n (Criteo campaign ~3e3 vs rows ~1e7), so the
    per-row cost collapses to one vectorized np.unique + one gather.
    This is the host-ingest hot loop of the sparse front door
    (bench.py ctr_front_door). Measured (200k rows, 1 core): numeric
    dedup 12.9x over the per-row path; string dedup ~equal to the
    native murmur batch (np.unique on fixed-width unicode costs what
    the C hash saves) but many-x when only the pure-Python hash is
    available, so strings dedup exactly when the native library is
    missing."""
    n = len(col)
    if col.dtype != object:            # numeric codes: stringify stably
        colf = col.astype(np.float64)
        null_mask = np.isnan(colf)
        # int64 cast is exact only in-range; route the rest through the
        # per-row exact path (Python int() is arbitrary-precision; inf
        # raises OverflowError there, same as the pre-dedup behavior)
        fast = ~null_mask & (np.abs(colf) < 2.0 ** 62)
        slow = ~null_mask & ~fast
        ints = colf[fast].astype(np.int64)
        res = np.empty(n, dtype=np.int32)
        if ints.size:
            uniq, inv = np.unique(ints, return_inverse=True)
            hashed = hash_tokens([_token(name, int(u)) for u in uniq],
                                 n_buckets, seed)
            res[fast] = hashed[inv]
        if slow.any():
            res[slow] = hash_tokens(
                [_token(name, int(v)) for v in colf[slow]],
                n_buckets, seed)
        if null_mask.any():
            res[null_mask] = hash_tokens([_token(name, None)],
                                         n_buckets, seed)[0]
        return res
    from ..native import available
    if available():                    # C murmur beats the dedup detour
        return hash_tokens([_token(name, v) for v in col.tolist()],
                           n_buckets, seed)
    # pure-python hash: one C pass to fixed-width unicode ('' stands
    # for null, matching _token), native-speed unique, hash uniques only
    su = np.where(np.frompyfunc(lambda v: v is None, 1, 1)(col).astype(bool),
                  "", col).astype("U")
    uniq, inv = np.unique(su, return_inverse=True)
    hashed = hash_tokens([_token(name, u if u else None) for u in uniq],
                         n_buckets, seed)
    return hashed[inv].astype(np.int32)


class SparseHashingVectorizer(SequenceTransformer):
    """K categorical features -> (n, K) int32 indices in a shared space.

    Nulls hash to a per-feature null token (the sparse analog of the dense
    vectorizers' null-indicator track). No fitting: the hash space is the
    vocabulary, exactly like the reference's hashing trick.
    """

    in_type = ft.FeatureType  # Text subtypes, Integral codes, MultiPickList
    out_type = ft.SparseIndices
    operation_name = "hashedSparse"

    def __init__(self, num_buckets: int = 1 << 20, seed: int = 42,
                 uid=None, **kw):
        super().__init__(uid=uid, num_buckets=int(num_buckets),
                         seed=int(seed), **kw)

    def _transform_columns(self, ds: Dataset):
        B = self.params["num_buckets"]
        seed = self.params["seed"]
        n = ds.n_rows
        out = np.zeros((n, len(self.inputs)), dtype=np.int32)
        for j, tf in enumerate(self.inputs):
            out[:, j] = _hash_column(ds.column(tf.name), tf.name, B, seed)
        return out, ft.SparseIndices, None

    def transform_value(self, *vs: ft.FeatureType):
        B = self.params["num_buckets"]
        seed = self.params["seed"]
        idx = []
        for tf, v in zip(self.inputs, vs):
            val = v.value if isinstance(v, ft.FeatureType) else v
            if isinstance(val, float) and not np.isnan(val):
                val = int(val)
            tok = _token(tf.name, val)
            idx.append(murmur3_32(tok.encode("utf-8"), seed) % B)
        return ft.SparseIndices(tuple(idx))


def hash_collision_stats(tokens: Sequence[str],
                         widths: Sequence[int] = tuple(
                             1 << p for p in range(18, 23)),
                         seed: int = 42) -> Dict[int, Dict[str, float]]:
    """Collision profile of a token vocabulary across hash widths.

    For each width B, hashes the DISTINCT tokens and reports how many
    land in occupied buckets — the quantity that decides the
    bucket-count knob for `SparseHashingVectorizer` (reference:
    OPCollectionHashingVectorizer's numFeatures). Use with the AUROC
    sweep in bench.py's CTR section to pick the narrowest width whose
    collisions don't cost accuracy.
    """
    distinct = sorted(set(tokens))
    out: Dict[int, Dict[str, float]] = {}
    for B in widths:
        idx = hash_tokens(distinct, int(B), seed)
        occupied = len(np.unique(idx))
        t = max(len(distinct), 1)
        out[int(B)] = {
            "distinct_tokens": float(len(distinct)),
            "occupied_buckets": float(occupied),
            "colliding_token_fraction": 1.0 - occupied / t,
        }
    return out
