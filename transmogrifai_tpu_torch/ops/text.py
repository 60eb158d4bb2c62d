"""Text tokenization (the port's copy of
``transmogrifai_tpu/ops/text.py``).

Reference: core/.../stages/impl/feature/TextTokenizer.scala (Lucene
per-language analyzers + LangDetector-driven analyzer choice). TPU build
keeps tokenization host-side (it feeds the hashing/vocab vectorizers) and
mirrors the Lucene pipeline natively: regex token split -> lowercase ->
per-language stopword filter -> stemmer (Porter for English, light
stemmers otherwise; see ops/analyzers.py). `language="auto"` detects the
language per value like the reference's autoDetectLanguage param.
"""
from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from ..dataset import column_to_numpy
from ..features import types as ft
from ..stages.base import UnaryTransformer
from .analyzers import analyze_tokens

_TOKEN_RE = re.compile(r"[^\W_]+", re.UNICODE)


def tokenize(text: Optional[str], min_token_length: int = 1,
             to_lowercase: bool = True, language: Optional[str] = None,
             remove_stopwords: bool = False, stem: bool = False) -> List[str]:
    if not text:
        return []
    if to_lowercase:
        text = text.lower()
    toks = [t for t in _TOKEN_RE.findall(text) if len(t) >= min_token_length]
    if language is None or not (remove_stopwords or stem):
        return toks
    if language == "auto":
        from .text_advanced import detect_language
        language = detect_language(text) or "en"
    return analyze_tokens(toks, language, remove_stopwords=remove_stopwords,
                          stem=stem)


class TextTokenizer(UnaryTransformer):
    """Text -> TextList of analyzed tokens.

    `language=None` keeps the bare regex split (hashing-trick default);
    `language="en"|...|"auto"` adds the Lucene-style stop+stem chain.
    """
    in_type = ft.Text
    out_type = ft.TextList
    operation_name = "tok"

    def __init__(self, min_token_length: int = 1, to_lowercase: bool = True,
                 language: Optional[str] = None,
                 remove_stopwords: bool = True, stem: bool = True,
                 uid=None, **kw):
        super().__init__(uid=uid, min_token_length=min_token_length,
                         to_lowercase=to_lowercase, language=language,
                         remove_stopwords=remove_stopwords, stem=stem, **kw)

    def _tokenize(self, s: Optional[str]) -> List[str]:
        p = self.params
        return tokenize(s, p["min_token_length"], p["to_lowercase"],
                        p["language"], p["remove_stopwords"], p["stem"])

    def transform_value(self, v: ft.Text):
        return ft.TextList(self._tokenize(v.value))

    def _transform_columns(self, ds):
        """Vectorized host path: one pass over the raw object column with
        no per-cell FeatureType wrappers (row-loop parity is tested)."""
        col = ds.column(self.input_names[0])
        tok = self._tokenize
        out = np.empty(len(col), dtype=object)
        for i, s in enumerate(col):
            out[i] = tuple(tok(s if isinstance(s, str) else None))
        return out, ft.TextList, None
