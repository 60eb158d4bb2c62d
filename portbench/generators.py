"""The benchmark's data generators, frozen copies of the smoke's.

Each function names the line it was copied from. Later changes to the
program or to ``chip_smoke.py`` leave these as they are: they are part
of the yardstick. Every generator is a pure function of its seed, on the
host in numpy, as a user's rows arrive on the host.
"""
from __future__ import annotations

import numpy as np

#: chip_smoke.py:1255, HIGGS' width
TRAIN_FEATURES = 28
#: chip_smoke.py:4436 (bench.py:3025-3027): Criteo's hashed categoricals,
#: numerics and buckets
CTR_K, CTR_D, CTR_BUCKETS = 26, 13, 1 << 20


def training_signal(seed: int, n: int, d: int = TRAIN_FEATURES):
    """Frozen copy of ``chip_smoke.py:1283`` (``training_signal``):
    HIGGS-shaped synthetic rows, ``d`` normal features and a nonlinear
    (XOR-style) signal of a few of them plus noise."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    z = (X[:, 0] * X[:, 1] + 0.5 * np.sin(2.0 * X[:, 2]) + 0.3 * X[:, 3]
         + 0.3 * rng.normal(size=n))
    return X, z


def training_data(seed: int, n: int, d: int = TRAIN_FEATURES):
    """Frozen copy of ``chip_smoke.py:1293`` (``training_data``): the
    binary label of :func:`training_signal`, balanced so the default
    DataBalancer keeps unit weights."""
    X, z = training_signal(seed, n, d)
    return X, (z > 0).astype(np.float32)


def ctr_chunk(seed: int, rows: int, buckets: int = CTR_BUCKETS) -> dict:
    """Frozen copy of ``chip_smoke.py:4460`` (``ctr_chunk``, itself a
    copy of bench.py:3030): a synthetic Criteo-like chunk of 26 hashed
    categoricals (two carry signal at realistic cardinality, the rest
    uniform noise over the whole table) and 13 numerics."""
    rng = np.random.default_rng(seed)
    n = rows
    idx = rng.integers(0, buckets, size=(n, CTR_K), dtype=np.int32)
    idx[:, 0] = rng.integers(0, 5000, n)
    idx[:, 1] = rng.integers(0, 3000, n)
    num = rng.normal(size=(n, CTR_D)).astype(np.float32)
    logit = ((idx[:, 0] % 7 < 3).astype(np.float32) * 1.2
             - (idx[:, 1] % 5 < 2).astype(np.float32) * 1.0
             + 0.5 * num[:, 0])
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return {"idx": idx, "num": num, "y": y, "w": np.ones(n, np.float32)}


def _fmix64(x: np.ndarray) -> np.ndarray:
    """MurmurHash3's 64-bit finaliser on uint64 values."""
    x = x ^ (x >> np.uint64(33))
    x = x * np.uint64(0xFF51AFD7ED558CCD)
    x = x ^ (x >> np.uint64(33))
    x = x * np.uint64(0xC4CEB9FE1A85EC53)
    return x ^ (x >> np.uint64(33))


def ctr_zipf(seed: int, rows: int, buckets: int = CTR_BUCKETS,
             cardinalities=(), exponent: float = 1.1) -> dict:
    """A Criteo-like chunk with Criteo's key skew: categorical column c
    draws its value's rank from a power law of ``exponent`` over
    ``cardinalities[c]`` distinct values (a truncated Pareto, floored:
    P(rank k) close to k^-exponent), hashed with its column into
    ``buckets``; 13 normal numerics; a label of the two first columns'
    ranks and the first numeric, about a quarter positive (as Criteo's
    clicks are)."""
    rng = np.random.default_rng(seed)
    n, a = rows, 1.0 - exponent
    idx = np.empty((n, len(cardinalities)), np.int32)
    ranks = []
    for c, card in enumerate(cardinalities):
        x = (1.0 + rng.random(n) * ((card + 1.0) ** a - 1.0)) ** (1.0 / a)
        r = np.minimum(x.astype(np.int64), card)
        ranks.append(r)
        key = (np.uint64(c) << np.uint64(40)) | r.astype(np.uint64)
        idx[:, c] = (_fmix64(key) & np.uint64(buckets - 1)).astype(np.int32)
    num = rng.normal(size=(n, CTR_D)).astype(np.float32)
    logit = ((ranks[0] % 7 < 3).astype(np.float32) * 1.2
             - (ranks[1] % 5 < 2).astype(np.float32) * 1.0
             + 0.5 * num[:, 0] - 1.4)
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return {"idx": idx, "num": num, "y": y, "w": np.ones(n, np.float32)}


GENERATORS = {"training_data": training_data, "ctr_chunk": ctr_chunk,
              "ctr_zipf": ctr_zipf}
