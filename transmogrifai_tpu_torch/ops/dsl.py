"""Feature DSL verbs (reference: core/.../dsl/Rich*Feature.scala).

The reference's implicit Rich*Feature classes give every Feature typed
verbs — `name.tokenize()`, `color.pivot()`, `price / quantity`,
`f.alias("x")` — that each append one stage to the lazy DAG. Here the
verbs register on Feature via `register_dsl` (type-checked at call time)
and the arithmetic operators install as dunder methods producing Real
features with NaN-propagating semantics, matching the reference's
RichNumericFeature (divide-by-zero -> null/NaN, not an error).

The port's copy of ``transmogrifai_tpu/ops/dsl.py`` (host code; its imports
are relative, so it is the JAX package's text).
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np

from ..dataset import Dataset
from ..features import types as ft
from ..features.feature import Feature
from ..stages.base import BinaryTransformer, UnaryTransformer
from .lda import OpLDA
from .ner import NameEntityRecognizer
from .parsers import AliasTransformer
from .text import TextTokenizer
from .text_advanced import (LangDetector, NGramTransformer,
                            TextLenTransformer, TfIdfVectorizer,
                            Word2VecEstimator)
from .vectorizers import DateToUnitCircle, OneHotVectorizer

_OPS = {
    "plus": np.add, "minus": np.subtract, "multiply": np.multiply,
    "divide": np.divide,
}


class ArithmeticTransformer(BinaryTransformer):
    """(numeric, numeric) -> Real via +, -, *, / (NaN propagates; x/0 ->
    NaN like the reference's null result, never an exception)."""
    in_types = (ft.OPNumeric, ft.OPNumeric)
    out_type = ft.Real

    def __init__(self, op: str = "plus", uid=None, **kw):
        if op not in _OPS:
            raise ValueError(f"unknown arithmetic op {op!r}")
        super().__init__(uid=uid, op=op, **kw)
        self.operation_name = op

    def _transform_columns(self, ds: Dataset):
        a = ds.column(self.input_names[0]).astype(np.float64)
        b = ds.column(self.input_names[1]).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = _OPS[self.params["op"]](a, b)
        return out, ft.Real, None

    def transform_value(self, a, b):
        av = a.value if a.value is not None else np.nan
        bv = b.value if b.value is not None else np.nan
        with np.errstate(divide="ignore", invalid="ignore"):
            r = float(_OPS[self.params["op"]](float(av), float(bv)))
        return ft.Real(None if np.isnan(r) else r)


class ScalarArithmeticTransformer(UnaryTransformer):
    """numeric (op) python-scalar -> Real (scalar on either side)."""
    in_type = ft.OPNumeric
    out_type = ft.Real

    def __init__(self, op: str = "plus", scalar: float = 0.0,
                 scalar_left: bool = False, uid=None, **kw):
        if op not in _OPS:
            raise ValueError(f"unknown arithmetic op {op!r}")
        super().__init__(uid=uid, op=op, scalar=float(scalar),
                         scalar_left=bool(scalar_left), **kw)
        self.operation_name = op

    def _apply(self, x):
        s = self.params["scalar"]
        a, b = (s, x) if self.params["scalar_left"] else (x, s)
        with np.errstate(divide="ignore", invalid="ignore"):
            return _OPS[self.params["op"]](a, b)

    def _transform_columns(self, ds: Dataset):
        col = ds.column(self.input_names[0]).astype(np.float64)
        return self._apply(col), ft.Real, None

    def transform_value(self, v):
        x = v.value if v.value is not None else np.nan
        r = float(self._apply(float(x)))
        return ft.Real(None if np.isnan(r) else r)


def _arith(self: Feature, other: Union[Feature, float, int], op: str,
           scalar_left: bool = False) -> Feature:
    if not issubclass(self.wtype, ft.OPNumeric):
        return NotImplemented
    if isinstance(other, Feature):
        if not issubclass(other.wtype, ft.OPNumeric):
            return NotImplemented
        return ArithmeticTransformer(op=op).set_input(self, other).output
    if isinstance(other, (int, float)):
        return ScalarArithmeticTransformer(
            op=op, scalar=other, scalar_left=scalar_left
        ).set_input(self).output
    return NotImplemented


def _install_operators() -> None:
    Feature.__add__ = lambda s, o: _arith(s, o, "plus")
    Feature.__radd__ = lambda s, o: _arith(s, o, "plus", scalar_left=True)
    Feature.__sub__ = lambda s, o: _arith(s, o, "minus")
    Feature.__rsub__ = lambda s, o: _arith(s, o, "minus", scalar_left=True)
    Feature.__mul__ = lambda s, o: _arith(s, o, "multiply")
    Feature.__rmul__ = lambda s, o: _arith(s, o, "multiply",
                                           scalar_left=True)
    Feature.__truediv__ = lambda s, o: _arith(s, o, "divide")
    Feature.__rtruediv__ = lambda s, o: _arith(s, o, "divide",
                                               scalar_left=True)


def _tokenize(self: Feature, **kw) -> Feature:
    return TextTokenizer(**kw).set_input(self).output


def _pivot(self: Feature, **kw) -> Feature:
    return OneHotVectorizer(**kw).set_input(self).output


def _alias(self: Feature, name: str) -> Feature:
    return AliasTransformer(name=name).set_input(self).output


def _detect_languages(self: Feature) -> Feature:
    return LangDetector().set_input(self).output


def _lda(self: Feature, **kw) -> Feature:
    return OpLDA(**kw).set_input(self).output


def _ner(self: Feature) -> Feature:
    return NameEntityRecognizer().set_input(self).output


def _text_len(self: Feature) -> Feature:
    return TextLenTransformer().set_input(self).output


def _bucketize(self: Feature, splits, **kw) -> Feature:
    from .numeric import NumericBucketizer
    return NumericBucketizer(splits=list(splits), **kw).set_input(self).output


def _autobucketize(self: Feature, label: Feature, **kw) -> Feature:
    from .numeric import DecisionTreeNumericBucketizer
    return DecisionTreeNumericBucketizer(**kw).set_input(label, self).output


def _zscore(self: Feature, **kw) -> Feature:
    from .numeric import ScalarStandardScaler
    return ScalarStandardScaler(**kw).set_input(self).output


def _to_unit_circle(self: Feature, **kw) -> Feature:
    return DateToUnitCircle(**kw).set_input(self).output


def _occurs(self: Feature, **kw) -> Feature:
    from .parsers import ToOccurTransformer
    return ToOccurTransformer(**kw).set_input(self).output


def _index(self: Feature, **kw) -> Feature:
    from .parsers import StringIndexer
    return StringIndexer(**kw).set_input(self).output


def _ngram(self: Feature, n: int = 2, **kw) -> Feature:
    return NGramTransformer(n=n, **kw).set_input(self).output


def _tf_idf(self: Feature, **kw) -> Feature:
    return TfIdfVectorizer(**kw).set_input(self).output


def _word2vec(self: Feature, **kw) -> Feature:
    return Word2VecEstimator(**kw).set_input(self).output


def _ngram_similarity(self: Feature, other: Feature, **kw) -> Feature:
    """f1.ngram_similarity(f2) — reference: RichTextFeature
    .toNGramSimilarity(other, nGramSize)."""
    from .text_advanced import SetNGramSimilarity
    return SetNGramSimilarity(**kw).set_input(self, other).output


def _to_phone(self: Feature, **kw) -> Feature:
    """Normalize to E.164 (RichPhoneFeature.toPhoneNumber)."""
    from .parsers import PhoneNumberParser
    return PhoneNumberParser(**kw).set_input(self).output


def _is_valid_phone(self: Feature, **kw) -> Feature:
    """RichPhoneFeature.isValidPhoneDefaultCountry."""
    from .parsers import IsValidPhoneTransformer
    return IsValidPhoneTransformer(**kw).set_input(self).output


def _phone_region(self: Feature, **kw) -> Feature:
    from .parsers import PhoneToRegion
    return PhoneToRegion(**kw).set_input(self).output


def _email_prefix(self: Feature, **kw) -> Feature:
    """RichEmailFeature.toEmailPrefix."""
    from .parsers import EmailPrefixTransformer
    return EmailPrefixTransformer(**kw).set_input(self).output


def _email_domain(self: Feature, **kw) -> Feature:
    """RichEmailFeature.toEmailDomain (PickList for topK pivot)."""
    from .parsers import EmailToPickList
    return EmailToPickList(**kw).set_input(self).output


def _url_domain(self: Feature, **kw) -> Feature:
    """RichURLFeature.toDomain."""
    from .parsers import UrlToDomain
    return UrlToDomain(**kw).set_input(self).output


def _is_valid_url(self: Feature, **kw) -> Feature:
    """RichURLFeature.isValidUrl."""
    from .parsers import IsValidUrlTransformer
    return IsValidUrlTransformer(**kw).set_input(self).output


def _mime_type(self: Feature, **kw) -> Feature:
    """RichBase64Feature.detectMimeTypes (Tika analog)."""
    from .parsers import MimeTypeDetector
    return MimeTypeDetector(**kw).set_input(self).output


def _to_time_period(self: Feature, period: str = "DayOfWeek",
                    **kw) -> Feature:
    """RichDateFeature.toTimePeriod."""
    from .parsers import TimePeriodTransformer
    return TimePeriodTransformer(period=period, **kw).set_input(self).output


def _to_percentile(self: Feature, **kw) -> Feature:
    """Score -> empirical percentile bucket (PercentileCalibrator)."""
    from .numeric import PercentileCalibrator
    return PercentileCalibrator(**kw).set_input(self).output


def _calibrate_isotonic(self: Feature, label: Feature, **kw) -> Feature:
    """score.calibrate_isotonic(label) — IsotonicRegressionCalibrator."""
    from .numeric import IsotonicRegressionCalibrator
    return IsotonicRegressionCalibrator(**kw).set_input(label, self).output


def _fill_missing_with_mean(self: Feature, **kw) -> Feature:
    """RichNumericFeature.fillMissingWithMean -> RealNN."""
    from .numeric import FillMissingWithMean
    return FillMissingWithMean(**kw).set_input(self).output


def _scale(self: Feature, **kw) -> Feature:
    """ScalerTransformer ('linear' slope/intercept or 'log')."""
    from .numeric import ScalerTransformer
    return ScalerTransformer(**kw).set_input(self).output


def _descale(self: Feature, scaled: Feature, **kw) -> Feature:
    """value.descale(scaled_feature) — inverts the scaled feature's
    origin ScalerTransformer (DescalerTransformer)."""
    from .numeric import DescalerTransformer
    return DescalerTransformer(**kw).set_input(self, scaled).output


def _deindex(self: Feature, labels, **kw) -> Feature:
    """index.deindex(labels) — OpIndexToString given the indexer's
    labels (read them off a fitted StringIndexer's params)."""
    from .parsers import IndexToString
    return IndexToString(labels=list(labels), **kw).set_input(self).output


def _drop_indices_by(self: Feature, match_fn=None, **kw) -> Feature:
    """vector.drop_indices_by(lambda col: ...) — RichVectorFeature
    .dropIndicesBy (manifest-predicate slot removal)."""
    from .parsers import DropIndicesByTransformer
    return DropIndicesByTransformer(match_fn=match_fn,
                                    **kw).set_input(self).output


def _combine(self: Feature, *others: Feature, **kw) -> Feature:
    """v1.combine(v2, ...) — RichVectorFeature.combine
    (VectorsCombiner concat with manifest concat)."""
    from .vectorizers import VectorsCombiner
    return VectorsCombiner(**kw).set_input(self, *others).output


def _filter_keys_verb(self: Feature, allow_keys=None, deny_keys=None,
                      **kw) -> Feature:
    """m.filter_keys(allow_keys=[...], deny_keys=[...]) —
    RichMapFeature.filter (type-preserving key filtering)."""
    from .maps import FilterMapTransformer
    return FilterMapTransformer(allow_keys=allow_keys,
                                deny_keys=deny_keys,
                                **kw).set_input(self).output


Feature.register_dsl("tokenize", _tokenize, types=(ft.Text,))
Feature.register_dsl("pivot", _pivot, types=(ft.Text,))
Feature.register_dsl("alias", _alias)
Feature.register_dsl("detect_languages", _detect_languages, types=(ft.Text,))
Feature.register_dsl("lda", _lda, types=(ft.Text,))
Feature.register_dsl("ner", _ner, types=(ft.Text,))
Feature.register_dsl("text_len", _text_len)
Feature.register_dsl("bucketize", _bucketize, types=(ft.OPNumeric,))
Feature.register_dsl("autobucketize", _autobucketize, types=(ft.OPNumeric,))
Feature.register_dsl("zscore", _zscore, types=(ft.OPNumeric,))
Feature.register_dsl("to_unit_circle", _to_unit_circle, types=(ft.Date,))
Feature.register_dsl("occurs", _occurs)
Feature.register_dsl("index", _index, types=(ft.Text,))
Feature.register_dsl("ngram", _ngram, types=(ft.Text, ft.TextList))
Feature.register_dsl("tf_idf", _tf_idf, types=(ft.Text, ft.TextList))
Feature.register_dsl("word2vec", _word2vec, types=(ft.Text, ft.TextList))
Feature.register_dsl("ngram_similarity", _ngram_similarity,
                     types=(ft.Text, ft.TextList, ft.MultiPickList))
Feature.register_dsl("to_phone", _to_phone, types=(ft.Phone,))
Feature.register_dsl("is_valid_phone", _is_valid_phone, types=(ft.Phone,))
Feature.register_dsl("phone_region", _phone_region, types=(ft.Phone,))
Feature.register_dsl("email_prefix", _email_prefix, types=(ft.Email,))
Feature.register_dsl("email_domain", _email_domain, types=(ft.Email,))
Feature.register_dsl("url_domain", _url_domain, types=(ft.URL,))
Feature.register_dsl("is_valid_url", _is_valid_url, types=(ft.URL,))
Feature.register_dsl("mime_type", _mime_type, types=(ft.Base64,))
Feature.register_dsl("to_time_period", _to_time_period, types=(ft.Date,))
Feature.register_dsl("to_percentile", _to_percentile, types=(ft.OPNumeric,))
Feature.register_dsl("calibrate_isotonic", _calibrate_isotonic,
                     types=(ft.OPNumeric,))
Feature.register_dsl("fill_missing_with_mean", _fill_missing_with_mean,
                     types=(ft.OPNumeric,))
Feature.register_dsl("scale", _scale, types=(ft.OPNumeric,))
Feature.register_dsl("descale", _descale, types=(ft.OPNumeric,))
Feature.register_dsl("deindex", _deindex, types=(ft.OPNumeric,))
Feature.register_dsl("drop_indices_by", _drop_indices_by,
                     types=(ft.OPVector,))
Feature.register_dsl("combine", _combine, types=(ft.OPVector,))
Feature.register_dsl("filter_keys", _filter_keys_verb, types=(ft.OPMap,))
_install_operators()
