from .base import (BinaryEstimator, BinaryTransformer, Estimator,
                   PipelineStage, Transformer)

__all__ = ["BinaryEstimator", "BinaryTransformer", "Estimator",
           "PipelineStage", "Transformer"]
