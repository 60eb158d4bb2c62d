from .base import (
    PipelineStage, Transformer, Estimator,
    UnaryTransformer, BinaryTransformer, TernaryTransformer,
    QuaternaryTransformer, SequenceTransformer, BinarySequenceTransformer,
    UnaryEstimator, BinaryEstimator, TernaryEstimator, QuaternaryEstimator,
    SequenceEstimator, BinarySequenceEstimator,
    LambdaTransformer, transformer, STAGE_REGISTRY,
)
from .generator import FeatureGeneratorStage, materialize_raw, raw_dataset_for
from .persistence import stage_to_json, stage_from_json
from .wrappers import (EstimatorWrapper, PredictorWrapper,
                       TransformerWrapper, WrappedModel)

__all__ = [
    "PipelineStage", "Transformer", "Estimator",
    "UnaryTransformer", "BinaryTransformer", "TernaryTransformer",
    "QuaternaryTransformer", "SequenceTransformer", "BinarySequenceTransformer",
    "UnaryEstimator", "BinaryEstimator", "TernaryEstimator",
    "QuaternaryEstimator", "SequenceEstimator", "BinarySequenceEstimator",
    "LambdaTransformer", "transformer", "STAGE_REGISTRY",
    "FeatureGeneratorStage", "materialize_raw", "raw_dataset_for",
    "stage_to_json", "stage_from_json",
    "EstimatorWrapper", "PredictorWrapper", "TransformerWrapper",
    "WrappedModel",
]
