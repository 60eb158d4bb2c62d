"""Traffic-learned FusedScorer bucket ladders.

Host code, copied from ``transmogrifai_tpu/autotune/buckets.py`` (it
imports nothing of either package): it runs on the port's
``workflow.FusedScorer._bucket_slices`` arithmetic, on ``EngineStats``'
batch-shape ring and on the engine swap and fleet rollout paths.

The serving engine coalesces concurrent requests into micro-batches
and pads each batch up to the next bucket of the scorer's ladder —
every padded row is wasted device work, and the static
DEFAULT_SCORE_BUCKETS ladder knows nothing about what a given fleet's
traffic actually looks like. This module closes the loop the
telemetry opened: the engine already records its observed batch-shape
mix (EngineStats batch-shape ring + the ``tm_engine_batch_shape_total``
/metricsz family), and :func:`propose_buckets` turns that mix into a
ladder that minimizes EXPECTED padded rows over the observed
distribution — computed with the exact arithmetic of
``FusedScorer._bucket_slices`` (mirrored in
:func:`expected_padded_rows`), so the objective IS the serving cost.

Safety is layered the way every serving change in this stack is:

* **Never-worse guard** (this module): a proposed ladder whose
  expected padded rows are not strictly better than the current
  ladder's on the same mix is REFUSED — the tuner returns the current
  ladder and says so in the report.
* **Warmed apply** (:func:`retune_buckets`): the ladder lands through
  the existing hot-swap (single engine) or staged-rollout (fleet)
  path: every bucket compiles before the flip, and a fleet rollout's
  bake-window verdict auto-rolls a ladder back if serving health
  regresses — a bad ladder never sticks (pinned by
  tests/test_torch_autotune.py's end-to-end drill).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["expected_padded_rows", "propose_buckets", "observed_mix",
           "mix_from_spans", "retune_buckets"]


def _slices(rows: int, ladder: Sequence[int]) -> Iterable[Tuple[int, int]]:
    """(real_rows, padded_rows) per dispatch for one batch of ``rows``
    through ``ladder`` — the exact FusedScorer._bucket_slices walk
    (top-bucket slices, then the remainder padded up to the smallest
    bucket that fits; an empty batch pads to the smallest bucket)."""
    if rows <= 0:
        yield 0, ladder[0]
        return
    top = ladder[-1]
    start = 0
    while rows - start > top:
        yield top, top
        start += top
    rem = rows - start
    yield rem, next(b for b in ladder if b >= rem)


def expected_padded_rows(mix: Dict[int, int],
                         ladder: Sequence[int]) -> float:
    """Total PADDING rows (wasted device lanes) dispatching the
    observed batch-row ``mix`` ({batch rows: count}) through
    ``ladder``. The cost function both the proposal greedy and the
    never-worse guard rank ladders by."""
    ladder = tuple(sorted({int(b) for b in ladder}))
    if not ladder or ladder[0] < 1:
        raise ValueError(f"invalid ladder {ladder!r}")
    total = 0.0
    for rows, count in mix.items():
        pad = sum(b - r for r, b in _slices(int(rows), ladder))
        total += pad * int(count)
    return total


def _aligned(v: int, align: int) -> int:
    return max(align, ((int(v) + align - 1) // align) * align)


def propose_buckets(mix: Dict[int, int], *, max_buckets: int = 8,
                    align: int = 8,
                    current: Optional[Sequence[int]] = None
                    ) -> Dict[str, Any]:
    """Propose a bucket ladder for the observed batch-row ``mix``.

    Greedy forward selection over the align-rounded observed sizes:
    start from the mandatory top bucket (covering the largest observed
    batch), repeatedly add the candidate that reduces
    :func:`expected_padded_rows` the most (deterministic tie-break:
    smaller candidate first), stop at ``max_buckets`` or when no
    candidate strictly improves. Fully deterministic: same mix ->
    same ladder.

    With ``current``, the NEVER-WORSE guard applies: a proposal that
    does not strictly beat the current ladder's expected padding on
    this mix is refused and the current ladder is returned
    (``accepted: False``). Returns a report dict either way.
    """
    if max_buckets < 1:
        raise ValueError("max_buckets must be >= 1")
    mix = {int(r): int(c) for r, c in mix.items() if int(c) > 0}
    if not mix:
        raise ValueError("cannot propose a ladder from an empty mix")
    top = _aligned(max(mix), align)
    candidates = sorted({_aligned(r, align) for r in mix if r > 0} - {top})
    ladder = [top]
    cost = expected_padded_rows(mix, ladder)
    while candidates and len(ladder) < max_buckets:
        best = None
        for c in candidates:        # ascending: ties pick the smallest
            trial = sorted(ladder + [c])
            tc = expected_padded_rows(mix, trial)
            if tc < cost and (best is None or tc < best[0]):
                best = (tc, c)
        if best is None:
            break
        cost, chosen = best[0], best[1]
        ladder = sorted(ladder + [chosen])
        candidates.remove(chosen)
    proposed = tuple(ladder)
    report: Dict[str, Any] = {
        "mix": {str(r): c for r, c in sorted(mix.items())},
        "proposed": list(proposed),
        "expected_padded_rows_proposed": cost,
        "accepted": True,
    }
    if current is not None:
        cur = tuple(sorted({int(b) for b in current}))
        cur_cost = expected_padded_rows(mix, cur)
        report["current"] = list(cur)
        report["expected_padded_rows_current"] = cur_cost
        if cost >= cur_cost:        # never worse than what serves today
            report["accepted"] = False
            report["proposed"] = list(cur)
            report["reason"] = (
                f"proposed ladder expects {cost:.0f} padded rows vs "
                f"{cur_cost:.0f} on the current ladder; keeping current")
            return report
        report["padding_reduction"] = (
            (cur_cost - cost) / cur_cost if cur_cost > 0 else 0.0)
    return report


# ---------------------------------------------------------------------------
# mix harvesting: engine stats ring + exported span timings
# ---------------------------------------------------------------------------

def observed_mix(stats, last_n: int = 4096) -> Dict[int, int]:
    """{batch rows: count} from an EngineStats batch-rows ring — the
    EXACT recent coalesced batch sizes (the pow2-bucketed
    ``tm_engine_batch_shape_total`` family is the scrape-visible
    mirror; the ring keeps full resolution for the tuner)."""
    mix: Dict[int, int] = {}
    for rows in stats.recent_batch_rows(last_n):
        mix[rows] = mix.get(rows, 0) + 1
    return mix


def mix_from_spans(spans: Iterable[Dict[str, Any]]) -> Dict[int, int]:
    """{batch rows: count} harvested from exported telemetry spans
    (``engine.batch`` spans carry a ``rows`` attr) — the offline
    harvest path: a Perfetto/JSONL trace from production is enough to
    retune a ladder without touching the live fleet."""
    mix: Dict[int, int] = {}
    for sp in spans:
        if sp.get("name") != "engine.batch":
            continue
        attrs = sp.get("attrs") or sp.get("args") or {}
        rows = attrs.get("rows", sp.get("rows"))
        if isinstance(rows, (int, float)) and rows >= 0:
            mix[int(rows)] = mix.get(int(rows), 0) + 1
    return mix


def _live_ladder(target) -> Optional[Tuple[int, ...]]:
    """The ladder ``target`` serves on RIGHT NOW, for the never-worse
    guard's default baseline: a fleet's construction-time ladder (the
    one rollout() inherits), or a single engine's default version's
    scorer buckets. None when not discoverable (unbucketed backend)."""
    fleet_buckets = getattr(target, "_buckets", None)
    if fleet_buckets:
        return tuple(fleet_buckets)
    registry = getattr(target, "registry", None)
    if registry is not None:
        try:
            backend = registry.get().backend
        except KeyError:
            return None
        buckets = getattr(backend, "buckets", None)
        if buckets:
            return tuple(buckets)
    return None


def retune_buckets(target, model, *, version: str,
                   mix: Optional[Dict[int, int]] = None,
                   max_buckets: int = 8,
                   current: Optional[Sequence[int]] = None,
                   warm_sample=None, **apply_kwargs) -> Dict[str, Any]:
    """Propose a ladder from the observed mix and apply it through the
    existing warmed serving path.

    ``target`` duck-types: a ServingFleet (has ``rollout``) applies via
    STAGED ROLLOUT — every replica bakes on the new ladder and any
    health regression rolls the whole fleet back automatically; a
    ServingEngine (has ``swap``) applies via the warmed hot-swap. A
    proposal the never-worse guard refuses is NOT applied; with
    ``current`` omitted the guard's baseline defaults to the ladder
    the target serves on today (:func:`_live_ladder`) — the guard only
    switches off when no current ladder is discoverable at all
    (unbucketed backend). Returns the proposal report, extended with
    ``applied`` and (for fleets) the rollout report."""
    if mix is None:
        stats = getattr(target, "stats", None)
        if stats is None or not hasattr(stats, "recent_batch_rows"):
            raise ValueError(
                "no mix= given and target exposes no batch-shape ring; "
                "harvest one with observed_mix()/mix_from_spans()")
        mix = observed_mix(stats)
    if current is None:
        current = _live_ladder(target)
    report = propose_buckets(mix, max_buckets=max_buckets,
                             current=current)
    report["applied"] = False
    if not report["accepted"]:
        return report
    ladder = tuple(report["proposed"])
    if hasattr(target, "rollout"):
        rollout = target.rollout(version, model, buckets=ladder,
                                 warm_sample=warm_sample, **apply_kwargs)
        report["rollout"] = rollout
        report["applied"] = not rollout.get("rolled_back", True)
    elif hasattr(target, "swap"):
        target.swap(version, model, buckets=ladder,
                    warm_sample=warm_sample, **apply_kwargs)
        report["applied"] = True
    else:
        raise TypeError(
            f"cannot apply a ladder to {type(target).__name__}: expected "
            f"a ServingFleet (rollout) or ServingEngine (swap)")
    return report
