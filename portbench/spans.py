"""The program's own spans in a traced window: the regions the fit path
enters (``telemetry/spans.py``'s ``REGIONS``) land among the trace's
host events under their names, on the clock of the device events.

``PROGRAM_SPANS`` is a frozen copy of those names as the readers know
them. The idle split (``idle_by_span``, ``idle_under``) is over the
names it is given, ``PROGRAM_SPANS`` by default: any other host event
is read like a torch or CUDA runtime event, that is, passed over. A
region the program adds later is named by the reader that reads it: the
reader freezes its names in its own file and passes
``names=PROGRAM_SPANS | MINE``, so the idle under its region is split
off from the region around it, and every other reader's split stays as
it was.
"""
from __future__ import annotations

from typing import AbstractSet, Callable, Dict, List, Optional, Tuple

import numpy as np

#: frozen copy of transmogrifai_tpu_torch/telemetry/spans.py's REGIONS
PROGRAM_SPANS = frozenset((
    "selector.fit", "selector.split", "selector.stage", "selector.dispatch",
    "selector.collect", "selector.refit", "sweep.chunk", "trees.bin",
    "trees.round", "trees.level", "trees.leaf_sums", "linear.solve",
    "linear.iter", "sparse.family", "sparse.step", "sparse.eval",
    "sparse.refit", "stream.produce", "stream.stage", "stream.wait",
    "workflow.layer", "workflow.stage"))


def spans(tr, name: str) -> np.ndarray:
    """(start, end) of every host event named ``name``, clipped to the
    window, (k, 2) in seconds."""
    lo, hi = tr.window
    rows = [tr.host[i] for i, n in enumerate(tr.host_names) if n == name]
    if not rows:
        return np.zeros((0, 2))
    iv = np.clip(np.array(rows, dtype=np.float64), lo, hi)
    return iv[iv[:, 1] > iv[:, 0]]


def seconds(tr, names) -> Optional[float]:
    """Summed seconds of the spans named in ``names`` (a name or a
    tuple), or None where the trace holds none of them."""
    names = (names,) if isinstance(names, str) else tuple(names)
    ivs = [spans(tr, n) for n in names]
    if not any(len(iv) for iv in ivs):
        return None
    return float(sum((iv[:, 1] - iv[:, 0]).sum() for iv in ivs))


def _segments(tr, names: AbstractSet[str] = PROGRAM_SPANS
              ) -> List[Tuple[float, float, Optional[str]]]:
    """The window cut where a span of ``names`` opens or closes: (start,
    end, innermost open span of ``names`` or None). Spans of one thread
    nest, so the innermost is the last opened of those still open."""
    lo, hi = tr.window
    evs = []
    for i, n in enumerate(tr.host_names):
        if n in names:
            s, e = tr.host[i]
            # at one instant: closes first, then opens, outer before inner
            evs.append((s, 1, -e, i))
            evs.append((e, 0, 0.0, i))
    evs.sort()
    out: List[Tuple[float, float, Optional[str]]] = []
    stack: List[int] = []
    t = lo
    for when, opens, _, i in evs:
        when = min(max(when, lo), hi)
        if when > t:
            out.append((t, when, tr.host_names[stack[-1]] if stack
                        else None))
            t = when
        if opens:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    if hi > t:
        out.append((t, hi, tr.host_names[stack[-1]] if stack else None))
    return out


def idle_by_span(tr, names: AbstractSet[str] = PROGRAM_SPANS
                 ) -> Dict[Optional[str], float]:
    """The device's idle seconds in the window by the innermost span of
    ``names`` open at each instant of idling (None: none open, the host
    in the harness's own code). Unlike ``Trace.idle_gaps``, which names a
    whole gap by what was open when it began, a gap that spans several
    program layers is split between them."""
    lo, hi = tr.window
    busy = tr.busy_intervals()
    edges = np.concatenate([[lo], busy.reshape(-1), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]].tolist()
    segs = _segments(tr, names)
    by: Dict[Optional[str], float] = {}
    j = 0
    for g0, g1 in gaps:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            s0, s1, name = segs[k]
            cut = min(s1, g1) - max(s0, g0)
            if cut > 0:
                by[name] = by.get(name, 0.0) + cut
            k += 1
    return by


def idle_under(tr, match: Callable[[str], bool],
               names: AbstractSet[str] = PROGRAM_SPANS) -> Optional[float]:
    """Idle seconds whose innermost open span of ``names`` ``match``
    accepts; None where no such span that it accepts is in the trace."""
    if not any(match(n) for n in set(tr.host_names) & names):
        return None
    return float(sum(v for n, v in idle_by_span(tr, names).items()
                     if n is not None and match(n)))
