from .base import (MODEL_FAMILIES, ModelFamily, ModelStage, PredictionModel,
                   params_from_numpy, params_to_numpy)
from . import linear  # registers the linear families (predict only)
from . import trees  # registers the tree families
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

__all__ = [
    "MODEL_FAMILIES", "ModelFamily", "ModelStage", "PredictionModel",
    "params_from_numpy", "params_to_numpy", "linear", "trees",
    "OpDecisionTreeClassifier", "OpDecisionTreeRegressor",
    "OpRandomForestClassifier", "OpRandomForestRegressor",
    "OpGBTClassifier", "OpGBTRegressor",
    "OpXGBoostClassifier", "OpXGBoostRegressor",
    "DataSplitter", "DataBalancer", "DataCutter",
    "OpCrossValidation", "OpTrainValidationSplit", "make_fold_masks",
    "ModelSelector", "SelectedModel", "BinaryClassificationModelSelector",
    "MultiClassificationModelSelector", "RegressionModelSelector",
]
