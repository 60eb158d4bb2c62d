from .base import (MODEL_FAMILIES, ModelFamily, ModelStage, PredictionModel,
                   params_from_numpy, params_to_numpy)
from . import linear  # registers the linear families
from . import trees  # registers the tree families
from . import ft_transformer  # registers the FT-Transformer families
from .ft_transformer import (OpFTTransformerClassifier,
                             OpFTTransformerRegressor)
from .stages import (OpLogisticRegression, OpLinearSVC, OpNaiveBayes,
                     OpLinearRegression, OpGeneralizedLinearRegression)
from .trees import (OpDecisionTreeClassifier, OpDecisionTreeRegressor,
                    OpRandomForestClassifier, OpRandomForestRegressor,
                    OpGBTClassifier, OpGBTRegressor,
                    OpXGBoostClassifier, OpXGBoostRegressor)
from .tuning import (DataSplitter, DataBalancer, DataCutter,
                     OpCrossValidation, OpTrainValidationSplit,
                     make_fold_masks)
from .selector import (ModelSelector, SelectedModel,
                       BinaryClassificationModelSelector,
                       MultiClassificationModelSelector,
                       RegressionModelSelector)
from .sparse import (SparseLogisticRegression, SparseLogisticModel,
                     SparseModelSelector, SparseSelectedModel,
                     SparseSoftmaxModel, SparseSoftmaxRegression,
                     fit_sparse_fm, fit_sparse_fm_sharded,
                     fit_sparse_fm_streaming,
                     fit_sparse_ftrl, fit_sparse_ftrl_streaming,
                     fit_sparse_lr, fit_sparse_lr_sharded,
                     fit_sparse_lr_streaming,
                     fit_sparse_softmax, fit_sparse_softmax_sharded,
                     fit_sparse_softmax_streaming,
                     predict_sparse_lr, predict_sparse_softmax,
                     validate_sparse_grid,
                     validate_sparse_grid_streaming)

__all__ = [
    "MODEL_FAMILIES", "ModelFamily", "ModelStage", "PredictionModel",
    "params_from_numpy", "params_to_numpy", "linear", "trees",
    "ft_transformer", "OpFTTransformerClassifier", "OpFTTransformerRegressor",
    "OpLogisticRegression", "OpLinearSVC", "OpNaiveBayes",
    "OpLinearRegression", "OpGeneralizedLinearRegression",
    "OpDecisionTreeClassifier", "OpDecisionTreeRegressor",
    "OpRandomForestClassifier", "OpRandomForestRegressor",
    "OpGBTClassifier", "OpGBTRegressor",
    "OpXGBoostClassifier", "OpXGBoostRegressor",
    "DataSplitter", "DataBalancer", "DataCutter",
    "OpCrossValidation", "OpTrainValidationSplit", "make_fold_masks",
    "ModelSelector", "SelectedModel", "BinaryClassificationModelSelector",
    "MultiClassificationModelSelector", "RegressionModelSelector",
    "SparseLogisticRegression", "SparseLogisticModel",
    "SparseModelSelector", "SparseSelectedModel", "SparseSoftmaxModel",
    "SparseSoftmaxRegression", "fit_sparse_fm", "fit_sparse_fm_sharded",
    "fit_sparse_fm_streaming", "fit_sparse_ftrl",
    "fit_sparse_ftrl_streaming", "fit_sparse_lr", "fit_sparse_lr_sharded",
    "fit_sparse_lr_streaming", "fit_sparse_softmax",
    "fit_sparse_softmax_sharded", "fit_sparse_softmax_streaming",
    "predict_sparse_lr", "predict_sparse_softmax", "validate_sparse_grid",
    "validate_sparse_grid_streaming",
]
