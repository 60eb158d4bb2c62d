"""Learned autotuning of the Hopper kernels' launches and of the
serving engine's bucket ladders.

Counterpart of ``transmogrifai_tpu/autotune``, with the same exports.
Two tuners, one package:

* **Kernel launch configs** (:mod:`.costmodel` + :mod:`.runtime`): a
  small deterministic cost model (shape/config descriptors -> predicted
  ms) of each hand-written kernel's own launch choices, trained on
  measurements taken on the card. With ``TM_AUTOTUNE=1`` and
  ``TM_AUTOTUNE_MODEL`` (the histogram, ``csrc/tree_histogram.cu``) or
  ``TM_AUTOTUNE_SERVING_MODEL`` (the fused scorer,
  ``csrc/fused_linear_scores.cu``) it picks each shape's launch: one
  cached prediction per shape, the static launch when off or
  model-less, every decision a flight-recorder record. Every candidate
  gives bitwise the static launch's output.
* **Bucket ladders** (:mod:`.buckets`): the serving engine's observed
  batch-shape mix (EngineStats ring / ``tm_engine_batch_shape_total``
  / exported ``engine.batch`` spans) -> a FusedScorer bucket ladder
  minimizing expected padded rows, never-worse-guarded and applied
  through the warmed hot-swap / staged-rollout path.

See ``transmogrifai_tpu_torch/docs/KNOBS.md`` for the knobs and the
README's port section for how to train and point the autotuner.
"""
from .buckets import (expected_padded_rows, mix_from_spans, observed_mix,
                      propose_buckets, retune_buckets)
from .costmodel import (KernelCostModel, ServingCostModel,
                        candidate_configs, featurize,
                        measurements_from_capture,
                        measurements_from_tune_record,
                        serve_candidate_configs, serve_featurize,
                        serve_measurements_from_capture,
                        serve_measurements_from_tune_record)
from .runtime import (AutotuneConfig, kernel_dispatch_log,
                      kernel_launch_config, reset_autotuner,
                      resolve_autotune_config, serving_dispatch_log,
                      serving_launch_config)

__all__ = [
    "AutotuneConfig", "KernelCostModel", "ServingCostModel",
    "candidate_configs", "expected_padded_rows", "featurize",
    "kernel_dispatch_log", "kernel_launch_config",
    "measurements_from_capture", "measurements_from_tune_record",
    "mix_from_spans", "observed_mix", "propose_buckets",
    "reset_autotuner", "resolve_autotune_config",
    "serve_candidate_configs", "serve_featurize",
    "serve_measurements_from_capture",
    "serve_measurements_from_tune_record", "serving_dispatch_log",
    "serving_launch_config", "retune_buckets",
]
