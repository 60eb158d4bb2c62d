"""transmogrifai_tpu_torch — the PyTorch/CUDA port of transmogrifai_tpu.

The JAX package (``transmogrifai_tpu``) stays the reference; this
package mirrors its module paths so each counterpart is easy to find,
and imports ``torch`` and numpy only — never ``jax`` and nothing of the
JAX package.

What is ported so far: fused multi-model serving of all-numeric
portable artifacts (impute -> concat -> keep_cols -> linear predict) —
``portable.load`` / ``portable.from_portable``, ``workflow.FusedScorer``,
``serving.ModelRegistry`` and ``serving.ServingEngine`` with the fused
cross-model plane, whose stacked linear heads score through the
hand-written CUDA kernel ``csrc/fused_linear_scores.cu``
(``models.serving_kernels.fused_linear_scores``).

Entry points run on the card unless the caller passes ``device="cpu"``
(see ``_device.resolve_device``).
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
