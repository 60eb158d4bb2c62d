"""Feature operations of the port: hashing, tokenizing, the per-type
vectorizers, the transmogrify dispatch, the hashed-sparse vectorizer,
sensitive-name detection and the SanityChecker. The JAX package's
other ``ops`` modules (parsers, maps, numeric, text_advanced, dsl,
analyzers, ner, lda) are not
ported yet; a branch that reaches one raises ``NotImplementedError``
naming it."""
from .hashing import hash_string, murmur3_32
from .text import TextTokenizer, tokenize
from .vectorizers import (
    RealVectorizer, RealVectorizerModel, BinaryVectorizer,
    OneHotVectorizer, OneHotModel, MultiPickListVectorizer, MultiPickListModel,
    TextHashingVectorizer, SmartTextVectorizer, SmartTextModel,
    DateToUnitCircle, GeolocationVectorizer, GeolocationModel, VectorsCombiner,
    VectorizerModel, impute_device_fn,
)
from .sensitive import HumanNameDetector, looks_like_name, name_stats
from .transmogrifier import (transmogrify, transmogrify_sparse,
                             default_vectorizer, default_vector_feature)
from .sanity_checker import SanityChecker, SanityCheckerModel
from .sparse import SparseHashingVectorizer, hash_collision_stats, hash_tokens

__all__ = [
    "hash_string", "murmur3_32", "TextTokenizer", "tokenize",
    "RealVectorizer", "RealVectorizerModel", "BinaryVectorizer",
    "OneHotVectorizer", "OneHotModel", "MultiPickListVectorizer",
    "MultiPickListModel", "TextHashingVectorizer", "SmartTextVectorizer",
    "SmartTextModel", "DateToUnitCircle", "GeolocationVectorizer",
    "GeolocationModel", "VectorsCombiner", "VectorizerModel",
    "impute_device_fn", "HumanNameDetector", "looks_like_name",
    "name_stats", "transmogrify", "transmogrify_sparse",
    "default_vectorizer", "default_vector_feature", "SanityChecker",
    "SanityCheckerModel", "SparseHashingVectorizer", "hash_collision_stats",
    "hash_tokens",
]
