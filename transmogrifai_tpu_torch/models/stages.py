"""Concrete model estimator stages of the linear families (the Op*
model wrappers).

Counterpart of ``transmogrifai_tpu/models/stages.py`` (reference:
OpLogisticRegression, OpLinearSVC, OpNaiveBayes, OpLinearRegression,
OpGeneralizedLinearRegression). Each fits its family with fixed hypers
on the stage's ``device`` (None: CUDA, raising without it). The tree
stages live in ``models/trees.py``.
"""
from __future__ import annotations

from . import linear  # noqa: F401  (registers the linear families)
from .base import ModelStage


class OpLogisticRegression(ModelStage):
    family_name = "LogisticRegression"
    problem = "binary"

    def __init__(self, uid=None, problem: str = "binary", device=None,
                 **hyper):
        super().__init__(uid=uid, device=device, **hyper)
        self.problem = problem


class OpLinearSVC(ModelStage):
    family_name = "LinearSVC"
    problem = "binary"


class OpNaiveBayes(ModelStage):
    family_name = "NaiveBayes"
    problem = "binary"

    def __init__(self, uid=None, problem: str = "binary", device=None,
                 **hyper):
        super().__init__(uid=uid, device=device, **hyper)
        self.problem = problem


class OpLinearRegression(ModelStage):
    family_name = "LinearRegression"
    problem = "regression"


class OpGeneralizedLinearRegression(ModelStage):
    family_name = "GeneralizedLinearRegression"
    problem = "regression"
