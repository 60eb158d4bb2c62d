"""Feature operations of the port (the port's copy of
``transmogrifai_tpu/ops/__init__.py``): hashing, tokenizing and
analyzers, the per-type and map vectorizers, parsers, numeric
bucketizers and scalers, advanced text, LDA, NER, sensitive-name
detection, the transmogrify dispatch, the hashed-sparse vectorizer
and the SanityChecker. Importing it installs the Feature DSL verbs
(``ops/dsl.py``), as the JAX package's ``import ops`` does."""
from .hashing import hash_string, murmur3_32
from .text import TextTokenizer, tokenize
from .vectorizers import (
    RealVectorizer, RealVectorizerModel, BinaryVectorizer,
    OneHotVectorizer, OneHotModel, MultiPickListVectorizer, MultiPickListModel,
    TextHashingVectorizer, SmartTextVectorizer, SmartTextModel,
    DateToUnitCircle, GeolocationVectorizer, GeolocationModel, VectorsCombiner,
    VectorizerModel, impute_device_fn,
)
from .maps import (
    RealMapVectorizer, RealMapModel, BinaryMapVectorizer, BinaryMapModel,
    TextMapPivotVectorizer, TextMapPivotModel,
    GeolocationMapVectorizer, GeolocationMapModel, default_map_vectorizer,
    DateMapVectorizer, DateMapModel, SmartTextMapVectorizer, SmartTextMapModel,
    FilterMapTransformer,
)
from .numeric import (
    NumericBucketizer, BucketizerModel, QuantileDiscretizer,
    DecisionTreeNumericBucketizer, DecisionTreeNumericMapBucketizer,
    ScalarStandardScaler, ScalerTransformer, DescalerTransformer,
    PredictionDescaler, PercentileCalibrator,
    IsotonicRegressionCalibrator, FillMissingWithMean,
)
from .sensitive import HumanNameDetector, looks_like_name, name_stats
from .text_advanced import (
    CountVectorizer, CountVectorizerModel, TfIdfVectorizer,
    NGramTransformer, SetNGramSimilarity, TextLenTransformer,
    LangDetector, detect_language, Word2VecEstimator, EmbeddingModel,
)
from .parsers import (
    PhoneNumberParser, IsValidPhoneTransformer, PhoneToRegion,
    parse_phone, parse_phone_info, phone_region,
    EmailToPickList, EmailPrefixTransformer, email_parts,
    UrlToDomain, IsValidUrlTransformer, url_domain,
    MimeTypeDetector, detect_mime,
    TimePeriodTransformer, time_period, DateListVectorizer,
    DateListVectorizerEstimator,
    StringIndexer, StringIndexerModel, IndexToString, OneHotEncoder,
    AliasTransformer, ToOccurTransformer, DropIndicesByTransformer,
)
from .transmogrifier import (transmogrify, transmogrify_sparse,
                             default_vectorizer,
                             default_vector_feature)

__all__ = [
    "hash_string", "murmur3_32", "TextTokenizer", "tokenize",
    "RealVectorizer", "RealVectorizerModel", "BinaryVectorizer",
    "OneHotVectorizer", "OneHotModel", "MultiPickListVectorizer",
    "MultiPickListModel", "TextHashingVectorizer", "SmartTextVectorizer",
    "SmartTextModel", "DateToUnitCircle", "GeolocationVectorizer",
    "GeolocationModel", "VectorsCombiner", "VectorizerModel",
    "impute_device_fn",
    "RealMapVectorizer", "RealMapModel", "BinaryMapVectorizer",
    "BinaryMapModel", "TextMapPivotVectorizer", "TextMapPivotModel",
    "GeolocationMapVectorizer", "GeolocationMapModel", "default_map_vectorizer",
    "DateMapVectorizer", "DateMapModel", "SmartTextMapVectorizer",
    "SmartTextMapModel", "FilterMapTransformer",
    "transmogrify", "transmogrify_sparse", "default_vectorizer",
    "default_vector_feature",
    "NumericBucketizer", "BucketizerModel", "QuantileDiscretizer",
    "DecisionTreeNumericBucketizer", "DecisionTreeNumericMapBucketizer",
    "ScalarStandardScaler", "ScalerTransformer", "DescalerTransformer",
    "PredictionDescaler",
    "PercentileCalibrator", "IsotonicRegressionCalibrator",
    "FillMissingWithMean",
    "HumanNameDetector", "looks_like_name", "name_stats",
    "CountVectorizer", "CountVectorizerModel", "TfIdfVectorizer",
    "NGramTransformer", "SetNGramSimilarity", "TextLenTransformer",
    "LangDetector",
    "detect_language", "Word2VecEstimator", "EmbeddingModel",
    "PhoneNumberParser", "IsValidPhoneTransformer", "PhoneToRegion",
    "parse_phone", "parse_phone_info", "phone_region",
    "EmailToPickList", "EmailPrefixTransformer", "email_parts",
    "UrlToDomain", "IsValidUrlTransformer", "url_domain",
    "MimeTypeDetector", "detect_mime", "TimePeriodTransformer",
    "time_period", "DateListVectorizer", "DateListVectorizerEstimator",
    "StringIndexer",
    "StringIndexerModel", "IndexToString", "OneHotEncoder",
    "AliasTransformer", "ToOccurTransformer", "DropIndicesByTransformer",
    "SanityChecker", "SanityCheckerModel", "SparseHashingVectorizer",
    "hash_collision_stats", "hash_tokens", "OpLDA", "LDAModel", "fit_lda",
    "infer_topics", "NameEntityRecognizer", "find_entities",
]
from .sanity_checker import SanityChecker, SanityCheckerModel  # registers .sanity_check verb
from .sparse import (SparseHashingVectorizer, hash_collision_stats,
                     hash_tokens)
from .lda import OpLDA, LDAModel, fit_lda, infer_topics
from .ner import NameEntityRecognizer, find_entities
from . import dsl  # installs Feature DSL verbs + arithmetic operators
