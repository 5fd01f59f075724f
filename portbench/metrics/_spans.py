"""The program's own spans and counters for the readers: the summary of
``coponerf_tpu_torch/trace.py`` over a traced run's slice after the window.

``rec["spans"]`` where a driver put one there (the 4-rank driver puts rank
0's, from steps every rank takes under ``trace.collecting()`` with no
profiler, so that no rank is slowed alone), else ``trace.summary()`` of
this process over its profiled slice (the spans are on while the profiler
records, and only then); None where the program has no tracer, as a
checkout from before it has not.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence


def summary(rec: Dict) -> Optional[Dict]:
    if "spans" in rec:
        return rec["spans"]
    try:
        from coponerf_tpu_torch import trace
    except ImportError:
        return None
    return trace.summary()


def per_unit(rec: Dict, names: Sequence[str], field: str, unit: str) -> Optional[float]:
    """The sum of ``field`` over the spans ``names``, per call of the span
    ``unit`` (an encode, an image, a step); None where a span is missing or
    has no such number (device times on a CPU)."""
    s = summary(rec)
    if s is None:
        return None
    spans = s["spans"]
    if unit not in spans or not spans[unit]["calls"] or any(n not in spans for n in names):
        return None
    values = [spans[n][field] for n in names]
    if any(v is None for v in values):
        return None
    return sum(values) / spans[unit]["calls"]
