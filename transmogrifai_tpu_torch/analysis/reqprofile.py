"""``--profile-requests``: rank request-plane segments from a trace.

Turns a span trace the serving stack already exports — Chrome
trace-event JSON (``Tracer.export_chrome`` / ``chrome_document``) or
span-per-line JSONL (``Tracer.export_jsonl``) — into the host-overhead
profile the request plane's fast path was built from: one row per span name
(``engine.prepare``, ``engine.queue``, ``engine.execute``,
``router.dispatch``, ...), ranked by TOTAL µs, with count / mean /
p50 / p99 per row. The top of this table is, by construction, where
request-plane optimization effort should go next.

The cross-host serving tier adds the ``transport.wire`` segment: the
client-attributed wire overhead per socket round trip (RTT minus the
worker-reported engine seconds — encode, TCP, decode, reader-thread
wakeup), recorded by ``SocketTransport`` with the worker identity in
its span attrs. It ranks here alongside admission/queue/build/resolve
with no special casing, so a trace from a socket fleet shows directly
whether serialization is the next bottleneck; if ``transport.wire``
tops the table, the documented foothold is a native frame codec in
``csrc/tmnative`` (docs/SERVING.md "Cross-host serving").

The device-side fused scoring tier adds ``engine.fused_dispatch``:
one batch span per fused FAMILY launch (requests / rows / models in
its attrs, sampled member requests fanned in), the fused counterpart
of ``engine.batch``. It needs no special casing here either — when it
ranks above the per-group dispatch segments at a given traffic mix,
the engine is already paying most of its device time through the
fused plane (docs/PERFORMANCE.md §11).

Format sniffing is structural, not by extension: a document whose
JSON parses to a dict with ``traceEvents`` is Chrome (ts/dur in µs,
complete events only — ``ph == "X"``); anything else is treated as
JSONL (ts/dur in SECONDS, one span dict per line). Ordering is
deterministic: (-total_us, name), so two runs over the same trace are
byte-identical.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

from ..profiling import percentile_nearest_rank


def load_trace(path: str) -> List[Tuple[str, float]]:
    """(span name, duration µs) pairs from a chrome/jsonl trace file.

    Raises ValueError with the offending detail on a file that is
    neither — a profile silently computed over zero spans would read
    as "the request plane costs nothing"."""
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    stripped = text.lstrip()
    if not stripped:
        raise ValueError(f"{path}: empty trace file")
    if stripped.startswith("{"):
        try:
            doc = json.loads(text)
        except json.JSONDecodeError:
            doc = None
        if isinstance(doc, dict) and "traceEvents" in doc:
            out = []
            for ev in doc["traceEvents"]:
                if ev.get("ph") != "X":
                    continue        # only complete events carry dur
                out.append((str(ev.get("name", "?")),
                            float(ev.get("dur", 0.0))))
            return out
    out = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        try:
            span = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"{path}:{lineno}: not chrome trace JSON and not a "
                f"JSONL span line ({e})") from None
        if not isinstance(span, dict) or "name" not in span:
            raise ValueError(
                f"{path}:{lineno}: JSONL span without a 'name' field")
        out.append((str(span["name"]),
                    float(span.get("dur", 0.0)) * 1e6))
    return out


def profile(spans: List[Tuple[str, float]]) -> List[Dict[str, Any]]:
    """One row per span name, ranked by total µs (descending; name
    breaks ties so the report is deterministic)."""
    by_name: Dict[str, List[float]] = {}
    for name, dur_us in spans:
        by_name.setdefault(name, []).append(dur_us)
    rows = []
    for name, durs in by_name.items():
        durs.sort()
        total = sum(durs)
        rows.append({
            "name": name,
            "count": len(durs),
            "total_us": total,
            "mean_us": total / len(durs),
            "p50_us": percentile_nearest_rank(durs, 0.50),
            "p99_us": percentile_nearest_rank(durs, 0.99),
        })
    rows.sort(key=lambda r: (-r["total_us"], r["name"]))
    return rows


def format_report(rows: List[Dict[str, Any]], path: str) -> str:
    """The text table (--profile-requests without --json)."""
    lines = [f"request-plane profile over {path}",
             f"{'segment':<24} {'count':>8} {'total_ms':>10} "
             f"{'mean_us':>9} {'p50_us':>9} {'p99_us':>9}"]
    if not rows:
        lines.append("(no spans in trace)")
        return "\n".join(lines)
    for r in rows:
        lines.append(
            f"{r['name']:<24} {r['count']:>8} "
            f"{r['total_us'] / 1e3:>10.3f} {r['mean_us']:>9.1f} "
            f"{r['p50_us']:>9.1f} {r['p99_us']:>9.1f}")
    top = rows[0]
    share = (100.0 * top["total_us"] / sum(r["total_us"] for r in rows)
             if rows else 0.0)
    lines.append(f"top segment: {top['name']} "
                 f"({top['total_us'] / 1e3:.3f} ms total, "
                 f"{share:.1f}% of traced time)")
    return "\n".join(lines)


def run(path: str, as_json: bool = False) -> str:
    """Load + profile + render (the __main__ entry)."""
    rows = profile(load_trace(path))
    if as_json:
        return json.dumps({"trace": path, "segments": rows},
                          indent=1, sort_keys=True)
    return format_report(rows, path)
