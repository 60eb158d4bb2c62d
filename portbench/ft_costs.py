"""The FLOPs of a published FT-Transformer fit, counted from shapes: the
products and attention of each row's forward (the last block on the CLS
query alone), three forwards' worth a row stepped (forward and backward),
one a row scored. Nothing here imports the program."""
from __future__ import annotations

from typing import Mapping


def forward_flops(d: int, D: int, L: int, F: int, k: int) -> float:
    """One row's forward: 2 FLOPs a multiply-add of every product and of
    the attention's logits and weighted values, over d + 1 tokens."""
    T = d + 1
    block = (2.0 * T * D * 3 * D          # Q, K, V
             + 2.0 * 2 * T * T * D        # logits, weighted values
             + 2.0 * T * D * D            # output projection
             + 2.0 * T * (D * 2 * F + F * D))   # ReGLU FFN
    last = (2.0 * T * D * 2 * D + 2.0 * D * D     # K, V of all; Q of CLS
            + 2.0 * 2 * T * D + 2.0 * D * D       # its attention, output
            + 2.0 * (D * 2 * F + F * D))          # its FFN
    return (L - 1) * block + last + 2.0 * D * k


def fit_flops(fit: Mapping) -> float:
    """A selector fit of the ``ft`` entry: every row stepped (the family's
    counter) at three forwards, every validation row of every grid point,
    the refit's training rows and the holdout rows at one."""
    m = fit["model"]
    fwd = forward_flops(fit["d"], m["d_token"], m["n_blocks"],
                        m["ffn_hidden"], 1)
    grid = len(fit["summary"]["validationResults"][0]["grid"])
    scored = fit["n_train"] * (grid + 1) + fit["n_holdout"]
    return fwd * (3.0 * fit["ft"]["rows_stepped"] + scored)
