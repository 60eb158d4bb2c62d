"""The checked-in JAX-format artifact ``tests/data/jax_features_model``.

A small workflow written by the JAX package on the CPU, holding the
stages the port's feature slice brings: parser chains (Email, URL,
Phone), map vectorizers (RealMap, PickListMap), ``OpLDA`` (the TextArea
default) and a ``RawFeatureFilter`` summary, ahead of the SanityChecker
and an LR selector. Beside the saved model: the raw rows it scores
(``rows.json``) and the JAX package's ``probability_1`` for each
(``scores.json``). ``chip_smoke.py`` loads it with the port on the card;
``tests/test_torch_features_e2e.py`` loads it in both packages.

Rewrite it (the JAX package's CPU fit is deterministic, so the files
come out the same)::

    JAX_PLATFORMS=cpu python tests/torch_artifact.py
"""
from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(HERE, "data", "jax_features_model")
ROWS = 160

_SPORTS = "game team score goal win player season match coach league".split()
_COOKING = "recipe oven flour sugar bake butter dough taste salt".split()
_DOMAINS = ("corp.com", "free.net", "mail.org")


def artifact_rows(n: int = ROWS, seed: int = 0) -> list:
    """JSON-friendly raw records: Email, URL, Phone, TextArea, RealMap,
    PickListMap, a Real, a nearly empty Real (the filter drops it) and
    the label."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        d = int(rng.integers(0, 3))
        topic = int(rng.integers(0, 2))
        words = _SPORTS if topic == 0 else _COOKING
        x = float(rng.normal())
        logit = 1.5 * (d == 0) - 1.0 * (d == 2) + 1.2 * topic + x - 0.5
        rows.append({
            "email": f"u{i}@{_DOMAINS[d]}",
            "site": (None if rng.random() < 0.1 else
                     f"https://{_DOMAINS[int(rng.integers(0, 3))]}/p{i % 7}"),
            "phone": ["(650) 123-4567", "+44 20 7946 0958", "12", None][
                int(rng.integers(0, 4))],
            "notes": " ".join(str(w) for w in rng.choice(words, 15)),
            "rm": {f"k{j}": float(rng.normal() + (d == 1))
                   for j in range(4) if rng.random() < 0.6},
            "pm": {f"k{j}": ["x", "y", "z"][int(rng.integers(0, 3))]
                   for j in range(3) if rng.random() < 0.5},
            "x": x,
            "sparse": float(rng.normal()) if rng.random() < 0.01 else None,
            "label": float(rng.random() < 1.0 / (1.0 + np.exp(-logit))),
        })
    return rows


SCHEMA = {"email": "Email", "site": "URL", "phone": "Phone",
          "notes": "TextArea", "rm": "RealMap", "pm": "PickListMap",
          "x": "Real", "sparse": "Real", "label": "RealNN"}


def build(pkg):
    """The artifact's workflow in package ``pkg`` (a package root
    module): transmogrify, SanityChecker, a 2-fold LR selector, the raw
    feature filter. Returns (workflow, result feature)."""
    import importlib
    ft = pkg.types
    ops = importlib.import_module(f"{pkg.__name__}.ops")
    M = importlib.import_module(f"{pkg.__name__}.models")
    W = importlib.import_module(f"{pkg.__name__}.workflow")
    pkg.reset_uids()
    feats = {}
    for name, t in SCHEMA.items():
        b = pkg.FeatureBuilder.of(getattr(ft, t), name).from_column()
        feats[name] = b.as_response() if name == "label" else \
            b.as_predictor()
    fv = ops.transmogrify([f for n, f in feats.items() if n != "label"])
    checked = ops.SanityChecker().set_input(feats["label"], fv).output
    pred = M.BinaryClassificationModelSelector.with_cross_validation(
        n_folds=2, candidates=[["LogisticRegression",
                                {"regParam": [0.01, 0.1]}]]
    ).set_input(feats["label"], checked).output
    wf = W.Workflow([pred]).with_raw_feature_filter(min_fill_rate=0.05)
    return wf, pred


def probabilities(model, rows) -> list:
    name = model.result_features[0].name
    return [float(r["probability_1"])
            for r in model.score(rows).column(name)]


def write(path: str = ARTIFACT) -> list:
    """Train the workflow with the JAX package on the CPU and write the
    model, its rows and its scores under ``path``."""
    import transmogrifai_tpu as J
    rows = artifact_rows()
    wf, _ = build(J)
    model = wf.train(data=rows)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    model.save(os.path.join(path, "model"))
    scores = probabilities(model, rows)
    with open(os.path.join(path, "rows.json"), "w") as f:
        json.dump(rows, f, indent=0)
    with open(os.path.join(path, "scores.json"), "w") as f:
        json.dump(scores, f, indent=0)
    return scores


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(HERE))
    write()
    print(f"wrote {ARTIFACT}")
