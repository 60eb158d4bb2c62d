"""transmogrifai_tpu_torch — the PyTorch/CUDA port of transmogrifai_tpu.

The JAX package (``transmogrifai_tpu``) stays the reference; this
package mirrors its module paths so each counterpart is easy to find,
and imports ``torch`` and numpy only — never ``jax`` and nothing of the
JAX package.

What is ported so far (ROADMAP.md lists the rest): fused multi-model
serving of all-numeric portable artifacts through the hand-written CUDA
kernel ``csrc/fused_linear_scores.cu``; AutoML training — the model
selector over the tree families (each tree level one launch of
``csrc/tree_histogram.cu``) and the linear families — and its
row-sharded form (``csrc/ring_allreduce.cu``); and the workflow front
door: readers, ``transmogrify`` over every feature type (parsers, maps,
numeric, advanced text, LDA, NER and sensitive-name detection, the
Feature DSL), the raw feature filter, the SanityChecker, ``Workflow`` /
``WorkflowModel`` (save/load in the JAX package's layout, scoring,
insights, export), the runner and local scoring; the Criteo path
(hashed sparse families, streamed); the test kit.

Entry points run on the card unless the caller passes ``device="cpu"``
(see ``_device.resolve_device``).
"""
from ._device import resolve_device
from .dataset import Dataset
from .features import (Feature, FeatureBuilder, ColumnManifest, ColumnMeta,
                       types, reset_uids)
from . import ops  # registers the Feature DSL verbs (tokenize/pivot/...,
#                    arithmetic operators), as the JAX package's
#                    ``import ops`` does

__all__ = ["resolve_device", "Dataset", "Feature", "FeatureBuilder",
           "ColumnManifest", "ColumnMeta", "types", "reset_uids", "ops"]
