"""Reading a torch.profiler trace of the measured window: device
intervals, their union, idle gaps named by what the host was doing, and
device time by kernel name.

``PROFILE_PAD_S`` is a frozen copy of ``chip_smoke.py:418``: the host
idles that long inside the profiler's recording before the traced work and after it,
because the profiler drops a device event whose time, read on the card's
clock, falls outside the recording's window on the host's.
"""
from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: frozen copy of chip_smoke.py:418
PROFILE_PAD_S = 0.05
#: the harness's own span around the traced window
WINDOW_SPAN = "portbench.window"


class Trace:
    """A traced window: device events (name, start, end) in seconds on
    the trace's clock, host events likewise, and the window's bounds."""

    def __init__(self, device: Sequence[Tuple[str, float, float]],
                 host: Sequence[Tuple[str, float, float]],
                 window: Tuple[float, float]):
        self.window = window
        self.dev_names = [d[0] for d in device]
        self.dev = np.array([(d[1], d[2]) for d in device],
                            dtype=np.float64).reshape(-1, 2)
        self.host_names = [h[0] for h in host]
        self.host = np.array([(h[1], h[2]) for h in host],
                             dtype=np.float64).reshape(-1, 2)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> np.ndarray:
        """The union of the device events inside the window, as disjoint
        sorted intervals."""
        return union(self.dev, self.window)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0.0

    def device_time(self, match) -> float:
        """Summed device seconds of the events whose name ``match``
        accepts."""
        return float(sum(e - s for n, (s, e) in zip(self.dev_names, self.dev)
                         if match(n)))

    def top_device_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, (s, e) in zip(self.dev_names, self.dev):
            by[n] = by.get(n, 0.0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], float(v)] for n, v in top]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """Idle seconds inside the window by the innermost host event open
        when each gap began (one sweep over the host events in start
        order, a stack of the open ones; the window's own span where no
        other is open), the ``k`` largest totals."""
        iv = self.busy_intervals()
        lo, hi = self.window
        edges = np.concatenate([[lo], iv.reshape(-1), [hi]]).reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
        by: Dict[str, float] = {}
        order = np.argsort(self.host[:, 0], kind="stable") \
            if len(self.host) else np.zeros(0, dtype=np.int64)
        hs = self.host[order, 0].tolist() if len(order) else []
        he = self.host[order, 1].tolist() if len(order) else []
        names = [self.host_names[i] for i in order.tolist()]
        stack: List[int] = []
        j = 0
        for g0, g1 in gaps.tolist():
            t = g0 + 1e-9
            while j < len(hs) and hs[j] <= t:
                while stack and he[stack[-1]] <= hs[j]:
                    stack.pop()
                stack.append(j)
                j += 1
            while stack and he[stack[-1]] <= t:
                stack.pop()
            name = names[stack[-1]] if stack else WINDOW_SPAN
            by[name] = by.get(name, 0.0) + (g1 - g0)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], float(v)] for n, v in top]


def union(iv: np.ndarray, window: Tuple[float, float]) -> np.ndarray:
    """Disjoint sorted union of intervals (n, 2), clipped to window."""
    if not len(iv):
        return np.zeros((0, 2))
    lo, hi = window
    iv = np.clip(iv, lo, hi)
    iv = iv[iv[:, 1] > iv[:, 0]]
    if not len(iv):
        return np.zeros((0, 2))
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = []
    cs, ce = iv[0]
    for s, e in iv[1:]:
        if s <= ce:
            ce = max(ce, e)
        else:
            out.append((cs, ce))
            cs, ce = s, e
    out.append((cs, ce))
    return np.array(out, dtype=np.float64)


def _ns(ev, what: str) -> float:
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(ev, what + "_us")()) * 1e3


def _annotation(ev) -> bool:
    """A host span mirrored on the device's timeline (the profiler's
    ``gpu_user_annotation``): no operation ran on the device."""
    if ev.name() == WINDOW_SPAN or ev.is_user_annotation():
        return True
    kind = getattr(ev, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def _events(prof):
    """(device, host) event lists from the profiler's raw results."""
    from torch.autograd import DeviceType
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = _ns(ev, "start") * 1e-9
        dur = _ns(ev, "duration") * 1e-9
        item = (ev.name(), s, s + dur)
        if ev.device_type() != DeviceType.CUDA:
            host.append(item)
        elif not _annotation(ev):
            device.append(item)
    return device, host


@contextlib.contextmanager
def traced(enabled: bool, cuda: bool = True, span: Optional[str] = None):
    """Profile the block (device and host activity) when ``enabled``,
    PROFILE_PAD_S of host idling on each side of it inside the recording,
    under the harness's window span. Yields a dict that holds the
    :class:`Trace` once the block has ended (None when not enabled). The
    traced window runs from the first host event named ``span`` (the
    harness's span around each unit of work) to the end of the last, or
    is the window span where none is given: what the profiler does at
    its own start and stop is no part of it."""
    out: Dict[str, Optional[Trace]] = {"trace": None}
    if not enabled:
        yield out
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        time.sleep(PROFILE_PAD_S)
        with record_function(WINDOW_SPAN):
            yield out
            sync()
        time.sleep(PROFILE_PAD_S)
    t0 = time.perf_counter()
    device, host = _events(prof)
    print(f"portbench: {len(device)} device and {len(host)} host events "
          f"read in {time.perf_counter() - t0:.1f} s", file=sys.stderr,
          flush=True)
    win = [h for h in host if h[0] == (span or WINDOW_SPAN)]
    if not win:
        raise RuntimeError(f"the trace holds no {span or WINDOW_SPAN} span")
    window = (min(h[1] for h in win), max(h[2] for h in win))
    out["trace"] = Trace(device, [h for h in host if h[0] != WINDOW_SPAN],
                         window)
