"""Sensitive-feature detection: human-name columns (the port's copy of
``transmogrifai_tpu/ops/sensitive.py``).

Reference: TransmogrifAI 0.7's sensitive feature detection —
core/.../stages/impl/feature/HumanNameDetector.scala (per-row
NameStats: isName + gender inferred from honorific/dictionary) and the
SmartTextVectorizer `sensitiveFeatureMode` integration that reports
detected columns through ModelInsights and can drop them from the
feature vector before any model sees them.

Design notes vs the reference:
- The name dictionary is the NER module's neutral lexicon
  (ops/ner_data.py) — one list, shared with the trained tagger, not a
  second embedded census.
- Gender inference uses ONLY explicit honorifics (Mr -> Male,
  Mrs/Ms/Miss -> Female, everything else -> Other). The reference also
  infers from first-name dictionaries; inferring gender from a name is
  both error-prone and invasive, so this build deliberately stops at
  what the text states outright. The NameStats SHAPE matches, so
  downstream consumers are drop-in.
"""
from __future__ import annotations

import functools
import re
from typing import Any, Dict, Optional

import numpy as np

from ..dataset import Dataset
from ..features import types as ft
from ..stages.base import UnaryEstimator, UnaryTransformer


_MALE_HON = {"mr", "sir", "lord"}
_FEMALE_HON = {"mrs", "ms", "miss", "lady", "madam"}


@functools.lru_cache(maxsize=None)
def _lexicons():
    from .ner_data import (HELD_FIRST, HELD_LAST, HONORIFICS, TRAIN_FIRST,
                           TRAIN_LAST)
    first = frozenset(n.lower() for n in TRAIN_FIRST + HELD_FIRST)
    last = frozenset(n.lower() for n in TRAIN_LAST + HELD_LAST)
    # ONE honorific set: the NER lexicon plus every honorific the
    # gender map knows — detection and gender inference must agree
    # ("Miss Kwame Acheampong" is a name exactly like "Mr. ...")
    hon = (frozenset(h.strip(".").lower() for h in HONORIFICS)
           | _MALE_HON | _FEMALE_HON)
    return first, last, hon
_TOKEN_RE = re.compile(r"[A-Za-z][A-Za-z.'-]*")


def _name_tokens(text: Optional[str]):
    """Lowercased stripped tokens when the text looks like a person
    name, else None. The single decision point both looks_like_name and
    name_stats share: capitalized 1-4 token string, no lowercase prose
    tokens, and either a known first/last name or an honorific LEADING
    a capitalized name ('Mr Coffee maker' has lowercase 'maker' and
    fails; a bare honorific is not a name)."""
    if not text:
        return None
    toks = _TOKEN_RE.findall(text)
    if not 1 <= len(toks) <= 4:
        return None
    first, last, hon = _lexicons()
    lowers = [t.strip(".'-").lower() for t in toks]
    leading_hon = lowers[0] in hon
    rest = toks[1:] if leading_hon else toks
    if not rest or any(t[:1].islower() for t in rest):
        return None
    if leading_hon:
        return lowers
    return lowers if any(tl in first or tl in last for tl in lowers) \
        else None


def looks_like_name(text: Optional[str]) -> bool:
    """Heuristic the detector aggregates — see _name_tokens."""
    return _name_tokens(text) is not None


def name_stats(text: Optional[str]) -> Dict[str, str]:
    """Per-row NameStats map (reference shape): isName + gender, the
    latter from explicit honorifics only (see module docstring)."""
    toks = _name_tokens(text)
    if toks is None:
        return {"isName": "false"}
    gender = "Other"
    if toks[0] in _MALE_HON:
        gender = "Male"
    elif toks[0] in _FEMALE_HON:
        gender = "Female"
    return {"isName": "true", "gender": gender}


class HumanNameDetector(UnaryEstimator):
    """Text -> per-row NameStats TextMap; the fitted model records the
    column-level verdict (pct_name vs threshold) for insights and for
    SmartTextVectorizer's sensitive handling."""
    in_type = ft.Text
    out_type = ft.TextMap
    operation_name = "nameDetect"

    class Model(UnaryTransformer):
        in_type = ft.Text
        out_type = ft.TextMap
        operation_name = "nameDetect"

        def __init__(self, is_name_column: bool = False,
                     pct_name: float = 0.0, uid=None, **kw):
            super().__init__(uid=uid, is_name_column=bool(is_name_column),
                             pct_name=float(pct_name), **kw)

        def _transform_columns(self, ds: Dataset):
            col = ds.column(self.input_names[0])
            out = np.empty(len(col), dtype=object)
            for i, v in enumerate(col):
                out[i] = name_stats(None if v is None else str(v))
            return out, ft.TextMap, None

        def transform_value(self, v: ft.Text):
            return ft.TextMap(name_stats(v.value))

    model_cls = Model

    def __init__(self, threshold: float = 0.5, uid=None, **kw):
        super().__init__(uid=uid, threshold=float(threshold), **kw)

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        pct = column_name_pct(ds.column(self.input_names[0]))
        return {"is_name_column": pct >= self.params["threshold"],
                "pct_name": pct}


def column_name_pct(col) -> float:
    """Fraction of non-null values that look like person names — the
    aggregation SmartTextVectorizer's sensitive mode runs at fit."""
    vals = [str(v) for v in col if v is not None and str(v) != ""]
    if not vals:
        return 0.0
    return sum(looks_like_name(v) for v in vals) / len(vals)
