"""Reduction of one ``torch.profiler`` window to the numbers the per-layer
readers take: device busy time, kernel launches, device time by kernel name,
and the longest idle gaps with the host operation running in each.

The window is the span of the ``record_function(WINDOW)`` annotation that
the drivers put around the profiled requests or steps; device activity is
clipped to it.  Nothing is written to disk.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

WINDOW = "portbench.window"
TOP = 10


def _is_device(e) -> bool:
    return "cuda" in str(e.device_type()).lower()


def _kind(e) -> str:
    try:
        return str(e.activity_type()).lower()
    except (AttributeError, RuntimeError):
        return ""


def _is_annotation(e) -> bool:
    """A span the profiler copies onto the device's timeline from a host
    annotation (``record_function``, the optimizer's step): no device work."""
    try:
        if e.is_user_annotation():
            return True
    except (AttributeError, RuntimeError):
        pass
    return "annotation" in _kind(e)


def _is_kernel(e) -> bool:
    kind = _kind(e)
    if kind:
        return "kernel" in kind
    name = e.name()
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_profile(prof) -> Dict:
    """{window_s, busy_s, launches, kernel_s {name: s}, kernel_n {name: count},
    device_ops [[name, s]], idle_gaps [[host op, s]]} of the annotated window."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW and not _is_device(e)]
    if not win:
        raise RuntimeError(f"no {WINDOW} annotation in the profile")
    w0 = min(e.start_ns() for e in win)
    w1 = max(e.start_ns() + e.duration_ns() for e in win)
    spans, kernel_s, kernel_n, host = [], {}, {}, []
    for e in events:
        a, d = e.start_ns(), e.duration_ns()
        if _is_device(e):
            if a + d <= w0 or a >= w1 or _is_annotation(e):
                continue
            spans.append((max(a, w0), min(a + d, w1)))
            if _is_kernel(e):
                kernel_s[e.name()] = kernel_s.get(e.name(), 0.0) + d * 1e-9
                kernel_n[e.name()] = kernel_n.get(e.name(), 0) + 1
        elif e.name() != WINDOW and d > 0 and a < w1 and a + d > w0:
            host.append((a, a + d, e.name()))
    busy = _merge(spans)
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    host.sort()
    starts = [h[0] for h in host]
    idle = []
    for a, b in gaps:
        mid = (a + b) // 2
        # the innermost host operation covering the gap's middle
        covering = [h for h in host[:bisect.bisect_right(starts, mid)] if h[1] >= mid]
        name = min(covering, key=lambda h: h[1] - h[0])[2] if covering else "(no host op)"
        idle.append([name, (b - a) * 1e-9])
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": sum(b - a for a, b in busy) * 1e-9,
        "launches": sum(kernel_n.values()),
        "kernel_s": kernel_s,
        "kernel_n": kernel_n,
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": idle,
    }
