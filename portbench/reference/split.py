"""The selector's data preparation, worked out again from its documented
rules (TransmogrifAI's DataBalancer, OpCrossValidation): a seeded
train/holdout split with a cap on the training rows, balancing weights
for a rare label, and seeded fold assignment."""
from __future__ import annotations

from typing import Tuple

import numpy as np

#: the selector's default seed, holdout share and training-row cap
SELECTOR_SEED = 42
RESERVE_FRACTION = 0.1
MAX_TRAINING_SAMPLE = 1_000_000
SAMPLE_FRACTION = 0.1


def train_holdout(n: int, seed: int = SELECTOR_SEED
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted (train, holdout) row indices: a seeded permutation, its
    first ``RESERVE_FRACTION`` held out, at most ``MAX_TRAINING_SAMPLE``
    of the rest trained on."""
    perm = np.random.default_rng(seed).permutation(n)
    n_hold = int(round(n * RESERVE_FRACTION))
    train = perm[n_hold:][:MAX_TRAINING_SAMPLE]
    return np.sort(train), np.sort(perm[:n_hold])


def balance_weights(y: np.ndarray) -> np.ndarray:
    """Row weights that lift a label rarer than ``SAMPLE_FRACTION`` to
    that share; unit weights otherwise."""
    y = y.astype(np.float32)
    n = len(y)
    n_pos = float(y.sum())
    n_neg = n - n_pos
    frac = n_pos / max(n, 1)
    w = np.ones(n, np.float32)
    t = SAMPLE_FRACTION
    if 0 < n_pos < n and frac < t:
        w = np.where(y > 0.5, t * n_neg / ((1 - t) * n_pos), 1.0)
    elif 0 < n_pos < n and 1 - frac < t:
        w = np.where(y < 0.5, t * n_pos / ((1 - t) * n_neg), 1.0)
    return w.astype(np.float32)


def fold_ids(n: int, folds: int, seed: int = SELECTOR_SEED) -> np.ndarray:
    """Each training row's validation fold."""
    return np.random.default_rng(seed).integers(0, folds, size=n)
