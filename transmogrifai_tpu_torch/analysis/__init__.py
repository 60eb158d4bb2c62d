"""opaudit: AST-driven invariant auditor for the port's own source.

Counterpart of ``transmogrifai_tpu/analysis``: the same passes and
codes, audited over ``transmogrifai_tpu_torch/``, the scripts that
drive it and its tests (``core.DEFAULT_ROOTS``), never over the JAX
package. ``trace-env`` reads the port's places where a decision
outlives the call (``lru_cache`` bodies, ``torch.compile`` / ``torch.jit``
/ CUDA-graph targets, the kernels' build); the registries read the
port's own documents under ``transmogrifai_tpu_torch/docs/``.

``lint/`` (opcheck) statically verifies user artifacts — workflow
DAGs, stage transform purity. This package points the same
never-execute discipline at the repo itself: the invariants code reviews
kept re-catching by hand are named passes that fail tier-1 when they
regress.

=================  ======================================================
pass               invariant
=================  ======================================================
trace-env          no os.environ read reachable from a frozen decision
                   (lru_cache, torch.compile/jit, CUDA graphs, the
                   kernels' build)
knob-registry      every TM_* env read routes through
                   resilience.config.parse_env_fields or a reasoned
                   allowlist entry
knob-docs          the port's docs/KNOBS.md matches the knob inventory
surface-registry   bench_gpu.py sections consistent across _SECTIONS/
                   _SECTION_ORDER/_DEVICE_SECTIONS/_summary_line
                   (nothing while the script is absent)
fault-registry     faults.POINTS == fault_point call sites ==
                   the port's docs/RESILIENCE.md rows
metric-registry    telemetry families documented; counters end _total
lock-discipline    static lock-nesting graph is acyclic; no
                   non-reentrant re-acquisition
stats-discipline   SnapshotStats subclasses mutate only via
                   _bump/_mutating/_lock
clone              no near-duplicate load-loop bodies in chip_smoke.py and
                   the port's tests
suppression        every waiver names a known pass and carries a reason
=================  ======================================================

CLI: ``python -m transmogrifai_tpu_torch.analysis`` (exit 0 == zero
unsuppressed findings). Suppression: ``# opaudit: disable=<pass> --
<reason>`` on (or directly above) the flagged line.
"""
from .core import (AUDIT_CATALOG, PASS_SLUGS, AuditContext, SourceFile,
                   load_context, run_audit)

__all__ = ["AUDIT_CATALOG", "PASS_SLUGS", "AuditContext", "SourceFile",
           "load_context", "run_audit"]
