"""Spark-free local scoring of saved workflow models (the port's copy of
``transmogrifai_tpu/local.py``).

Reference: local/src/main/scala/com/salesforce/op/local/
(OpWorkflowModelLocal.scala, `scoreFunction` / `enrichedScoreFunction`) —
per-record Map->Map scoring with no cluster runtime. There, OP stages run
as row functions and Spark-wrapped models go through the MLeap runtime;
here every stage already exposes `make_row_fn`, so the scorer composes
those (the model stage's row fn runs the family's predict at batch 1 on
the model's device: None resolves to CUDA, raising without a card).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping

from .workflow import WorkflowModel

__all__ = ["LocalScorer", "load_model_local"]


class LocalScorer:
    """Callable record scorer: `scorer({...}) -> {result_name: value}`.

    `enriched=True` echoes the input record's raw feature values alongside
    the results (the reference's enrichedScoreFunction).
    """

    def __init__(self, model: WorkflowModel, enriched: bool = False,
                 device=None):
        self.model = model.to(device)
        self.enriched = enriched
        self._row_fn = model.scoring_row_fn()
        self._raw_names = [f.name for f in model.raw_features
                           if not f.is_response]

    def __call__(self, record: Mapping[str, Any]) -> Dict[str, Any]:
        out = self._row_fn(dict(record))
        if self.enriched:
            enriched = {n: record.get(n) for n in self._raw_names}
            enriched.update(out)
            return enriched
        return out

    def score_batch(self, records: Iterable[Mapping[str, Any]]
                    ) -> List[Dict[str, Any]]:
        """Batch path: one vectorized pass through the fitted stages (the
        per-record path repeated would retrace nothing but still loops in
        Python; this rides the same device batch kernels as `score`)."""
        records = [dict(r) for r in records]
        ds = self.model.score(records)
        names = [f.name for f in self.model.result_features if f.name in ds]
        out = []
        for i in range(ds.n_rows):
            row = {n: ds.raw_value(n, i) for n in names}
            if self.enriched:
                e = {n: records[i].get(n) for n in self._raw_names}
                e.update(row)
                row = e
            out.append(row)
        return out


def load_model_local(path: str, enriched: bool = False,
                     device=None) -> LocalScorer:
    """Load a saved workflow model into a local scorer on ``device``
    (OpWorkflowModel.loadModelLocal)."""
    return LocalScorer(WorkflowModel.load(path, device=device),
                       enriched=enriched, device=device)
