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
door: readers, ``transmogrify``, the SanityChecker, ``Workflow`` /
``WorkflowModel`` (save/load in the JAX package's layout, scoring,
insights, export), the runner and local scoring.

Entry points run on the card unless the caller passes ``device="cpu"``
(see ``_device.resolve_device``).
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
