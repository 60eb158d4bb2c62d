"""Retry, watchdog-timeout, and graceful-degradation policies (the port's copy of
``transmogrifai_tpu/resilience/policy.py``).

Production AutoML trains run for hours on preemptible capacity; the
reference leaned on Spark's task retries (``spark.task.maxFailures``)
and lineage recomputation, neither of which a jax_graft port inherits.
This module supplies the host-side equivalent:

* :class:`RetryPolicy` — bounded attempts around one unit of work
  (a stage fit, a registry artifact load, a reader materialization)
  with exponential backoff, DETERMINISTIC seeded jitter (two runs of
  the same drill sleep the same schedule — flaky tests are how retry
  bugs hide), retryable-exception classification, and an optional
  per-attempt wall-clock watchdog.
* :func:`is_retryable` — the classification rule: an exception is
  retried only when it marks itself ``retryable = True``
  (TransientFaultError, StageTimeoutError), is one of the
  conventionally-transient stdlib types (ConnectionError,
  ``BrokenPipeError``, ``InterruptedError``), or appears in the
  policy's explicit ``retryable`` tuple. Everything else — including
  a genuinely corrupt artifact or a type error — propagates on the
  first attempt; retrying a deterministic failure only delays the
  report.
* ``failure_policy`` — stages declaring ``failure_policy="degrade"``
  (stages.base.PipelineStage.with_failure_policy) are SKIPPED by the
  training executor when their retries exhaust: the stage's output is
  dropped from the remaining plan (prune_layers cascade), and the
  train completes with a ``train_summaries["degraded"]`` record
  surfaced through model_insights and serving /statusz. The opcheck
  linter refuses degrade markers on outputs a model consumes
  non-optionally (TM-LINT-010) — degrading those would silently
  change model semantics.

The watchdog runs the attempt on a daemon thread and abandons it on
timeout (host Python cannot safely interrupt arbitrary C/XLA calls);
the abandoned thread never blocks pool shutdown or interpreter exit.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Optional, Tuple

#: stdlib exception types conventionally transient (I/O interrupted,
#: peer went away) — retried by default
TRANSIENT_TYPES: Tuple[type, ...] = (ConnectionError, BrokenPipeError,
                                     InterruptedError)

#: accepted stage failure policies
FAILURE_POLICIES = ("fail", "degrade")


class StageTimeoutError(TimeoutError):
    """An attempt exceeded the policy's wall-clock watchdog. Retryable:
    a transient stall (device tunnel hiccup, FS pause) is the expected
    cause; a deterministic hang exhausts the attempt budget and then
    fails (or degrades) like any other error."""

    retryable = True


class RetriesExhausted(RuntimeError):
    """All attempts failed. ``__cause__`` is the LAST attempt's error;
    ``attempts`` records how many ran (the degrade record keeps it)."""

    def __init__(self, what: str, attempts: int, last: BaseException):
        super().__init__(
            f"{what}: {attempts} attempt(s) exhausted; last error: "
            f"{type(last).__name__}: {last}")
        self.attempts = attempts
        self.last = last


def is_retryable(exc: BaseException,
                 extra: Tuple[type, ...] = ()) -> bool:
    marked = getattr(exc, "retryable", None)
    if marked is not None:
        return bool(marked)
    return isinstance(exc, TRANSIENT_TYPES + tuple(extra))


def _run_with_watchdog(fn: Callable[[], Any], timeout_s: float,
                       what: str) -> Any:
    """Run ``fn`` on a daemon thread, abandon it past ``timeout_s``.

    The abandoned thread keeps running (Python cannot kill it) but is a
    daemon: it never blocks executor pool shutdown, the exception path,
    or interpreter exit — the caller gets a prompt StageTimeoutError
    instead of a silent multi-hour stall."""
    box: dict = {}
    done = threading.Event()

    def run():
        from ..profiling import nan_checks
        try:
            with nan_checks():      # a debug_nans run checks its workers
                box["value"] = fn()
        except BaseException as e:      # noqa: BLE001 — re-raised below
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True,
                         name=f"tm-watchdog[{what}]")
    t.start()
    if not done.wait(timeout_s):
        raise StageTimeoutError(
            f"{what} exceeded the {timeout_s}s wall-clock watchdog "
            f"(the attempt thread was abandoned)")
    if "error" in box:
        raise box["error"]
    return box["value"]


class RetryPolicy:
    """Bounded, deterministic retry around one unit of work.

    ``attempts`` — total tries (1 = no retry; the no-overhead default).
    ``backoff_s`` / ``backoff_mult`` / ``max_backoff_s`` — exponential
    schedule: sleep ``backoff_s * mult**k`` (capped) before retry k+1.
    ``jitter`` — +/- fraction of the sleep drawn from a PRNG seeded by
    ``(seed, what, attempt)``: spread under fleet-wide contention, yet
    bit-identical across reruns of the same drill.
    ``timeout_s`` — optional per-ATTEMPT wall-clock watchdog.
    ``retryable`` — extra exception types to classify transient.
    """

    def __init__(self, attempts: int = 1, backoff_s: float = 0.05,
                 backoff_mult: float = 2.0, max_backoff_s: float = 5.0,
                 jitter: float = 0.1, seed: int = 0,
                 timeout_s: Optional[float] = None,
                 retryable: Tuple[type, ...] = ()):
        if attempts < 1:
            raise ValueError("attempts must be >= 1")
        self.attempts = int(attempts)
        self.backoff_s = float(backoff_s)
        self.backoff_mult = float(backoff_mult)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self.timeout_s = timeout_s
        self.retryable = tuple(retryable)

    def sleep_for(self, what: str, attempt: int) -> float:
        """Deterministic backoff before retry ``attempt`` (1-based
        count of FAILED attempts so far)."""
        base = min(self.backoff_s * self.backoff_mult ** (attempt - 1),
                   self.max_backoff_s)
        if not self.jitter:
            return base
        rng = random.Random(f"{self.seed}|{what}|{attempt}")
        return base * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))

    def run(self, fn: Callable[[], Any], what: str = "task",
            on_retry: Optional[Callable[[int, BaseException], None]] = None
            ) -> Any:
        """Execute ``fn`` under this policy.

        Raises :class:`RetriesExhausted` (cause = last error) when a
        retryABLE error survives every attempt; non-retryable errors
        propagate immediately, unwrapped, so callers keep their
        original error surface when no retry semantics applied."""
        last: Optional[BaseException] = None
        for attempt in range(1, self.attempts + 1):
            try:
                if self.timeout_s is not None:
                    return _run_with_watchdog(fn, self.timeout_s, what)
                return fn()
            except (KeyboardInterrupt, SystemExit):
                raise               # user intent is never a retry case
            except BaseException as e:  # noqa: BLE001 — classified below
                if not is_retryable(e, self.retryable) \
                        or self.attempts == 1:
                    # no retry semantics applied (non-retryable error,
                    # or a 1-attempt policy): the ORIGINAL exception is
                    # the caller's error surface, unwrapped
                    raise
                last = e
                if attempt >= self.attempts:
                    break
                if on_retry is not None:
                    on_retry(attempt, e)
                time.sleep(self.sleep_for(what, attempt))
        raise RetriesExhausted(what, self.attempts, last) from last

    def as_dict(self) -> dict:
        return {"attempts": self.attempts, "backoff_s": self.backoff_s,
                "backoff_mult": self.backoff_mult,
                "max_backoff_s": self.max_backoff_s,
                "jitter": self.jitter, "seed": self.seed,
                "timeout_s": self.timeout_s}


#: a policy that never retries and never times out — the executor
#: default, preserving the pre-PR error surface exactly
NO_RETRY = RetryPolicy(attempts=1)


def resolve_train_policy(explicit: Optional["RetryPolicy"] = None
                         ) -> "RetryPolicy":
    """The stage-fit policy for Workflow.train: an explicit RetryPolicy
    wins; else ``TM_TRAIN_RETRIES`` (attempt count) and
    ``TM_STAGE_TIMEOUT_S`` (per-attempt watchdog) build one; else
    NO_RETRY."""
    if explicit is not None:
        return explicit
    from .config import parse_env_fields
    fields = parse_env_fields(
        "TM_TRAIN_RETRIES",
        {"TM_TRAIN_RETRIES": ("attempts", int)},
        what="train retry env var")
    fields.update(parse_env_fields(
        "TM_STAGE_TIMEOUT_S",
        {"TM_STAGE_TIMEOUT_S": ("timeout_s", float)},
        what="stage timeout env var"))
    if not fields:
        return NO_RETRY
    return RetryPolicy(attempts=fields.get("attempts", 1),
                       timeout_s=fields.get("timeout_s"))
