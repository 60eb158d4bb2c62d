"""Deterministic feature hashing (the port's copy of
``transmogrifai_tpu/ops/hashing.py``).

Reference: core/.../stages/impl/feature/OPCollectionHashingVectorizer.scala,
OpHashingTF.scala (MurmurHash3 via Spark's HashingTF). Python's builtin
hash() is salted per-process, so we use a stable 32-bit murmur3 implemented
here (no external deps) — persisted models must hash identically forever.
"""
from __future__ import annotations


def murmur3_32(data: bytes, seed: int = 42) -> int:
    """Pure-python murmur3 x86 32-bit (stable across processes)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n = len(data)
    rounded = n - (n % 4)
    for i in range(0, rounded, 4):
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def hash_string(s: str, num_bins: int, seed: int = 42) -> int:
    return murmur3_32(s.encode("utf-8"), seed) % num_bins
