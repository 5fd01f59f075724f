"""Spans and counters inside the port, on the profiler's clock.

``span(name)`` marks a stage of the program (``encode``, ``render``,
``train_step`` and their stages; README's "Tracing" lists them).  It is
off outside ``collecting()`` and while no ``torch.profiler`` session
records: it then returns one shared no-op context, and costs one check.
On, it enters ``torch.profiler.record_function(name)``, so the stage lies
in a kineto trace on the device activity's clock, and keeps a record in
memory: the name, the enclosing span, the host start and end
(``time.perf_counter_ns``), a ``torch.cuda.Event`` pair on the current
stream where CUDA is initialised, and what the counters below and the
kernel wrappers' launch counters (``<wrapper>.launches``) gained while it
was open.  At most ``CAP`` records are kept; spans past it only count in
``dropped``.  Nothing is written to disk.

``count(name, n)`` adds to the always-on integer counters:
  host_syncs   each point of the model, the train step and the evaluation
               harness where the host waits for the device (a blocking
               host-to-device copy, ``torch.linalg.inv``'s check, a tensor
               read on the host); counted on every device alike
  collectives  each ``all_reduce``/``broadcast`` of ``parallel/`` and of the
               losses' global normalisers
  encode_graph_replays  each inference encode that replays its CUDA graphs
               (``models/encode_graph.py``) instead of launching eagerly
  k6_value_rows, k6_value_slots  each ``render_core`` (K6) launch's rays and
               the row slots of its groups' value products
               (``ops/render_core.py:value_counts``)

``summary()`` groups the finished records by name; ``reset()`` clears the
records, ``dropped`` and these counters (the launch counters belong to
their wrappers and stay).  Spans nest per thread.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import threading
import time
from typing import Any, Dict, List, Optional

import torch

CAP = 10000
# the kernel wrappers whose ``.launches`` the summary reports, by module of ``ops``
_WRAPPERS = (
    ("attn_embed", "round1_logits"), ("attn_embed", "round2_logits"),
    ("bilinear_sample", "bilinear_sample"), ("bilinear_sample", "corner_sample"),
    ("bilinear_sample", "grid_sample_window"), ("bilinear_sample", "multilevel_sample"),
    ("bilinear_sample", "onehot_transpose_matmul"), ("render_core", "render_core"),
    ("soft_argmax", "soft_argmax_bwd"), ("soft_argmax", "soft_argmax_stats"),
    ("split_matmul", "split_dense_relu"), ("weighted_sum", "weighted_sum_smaj"),
)

counters: Dict[str, int] = {"host_syncs": 0, "collectives": 0, "encode_graph_replays": 0, "k6_value_rows": 0,
                            "k6_value_slots": 0}
_records: List["_Record"] = []
_dropped = 0
_collecting = 0
_local = threading.local()
_wrappers: List[Any] = []
_profiler_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def count(name: str, n: int = 1) -> None:
    counters[name] += n


def _launch_fns() -> List[Any]:
    if not _wrappers:
        _wrappers.extend(getattr(importlib.import_module(f"coponerf_tpu_torch.ops.{mod}"), fn)
                         for mod, fn in _WRAPPERS)
    return _wrappers


def _snapshot():
    return tuple(counters.values()), tuple(f.launches for f in _launch_fns())


class _Record:
    __slots__ = ("name", "parent", "t0", "t1", "ev0", "ev1", "start", "delta")

    def __init__(self, name: str, parent: Optional["_Record"]):
        self.name, self.parent, self.t1, self.ev1, self.delta = name, parent, None, None, None
        self.ev0 = None
        if torch.cuda.is_initialized():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.start = _snapshot()
        self.t0 = time.perf_counter_ns()

    def finish(self) -> None:
        self.t1 = time.perf_counter_ns()
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record()
        end = _snapshot()
        self.delta = tuple(tuple(b - a for a, b in zip(s, e)) for s, e in zip(self.start, end))


class _Span:
    __slots__ = ("name", "rf", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _dropped
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        stack = _stack()
        if len(_records) >= CAP:
            _dropped += 1
            self.rec = None
            return self
        self.rec = _Record(self.name, stack[-1] if stack else None)
        _records.append(self.rec)
        stack.append(self.rec)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.finish()
            stack = _stack()
            if stack and stack[-1] is self.rec:
                stack.pop()
        self.rf.__exit__(*exc)
        return False


def _stack() -> List[_Record]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str):
    """A context manager over one stage; the shared no-op context when off."""
    if _collecting or _profiler_enabled():
        return _Span(name)
    return _OFF


def spanned(name: str):
    """Decorator: the whole call is ``span(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


@contextlib.contextmanager
def collecting():
    """Record spans inside this context, with or without a profiler."""
    global _collecting
    _collecting += 1
    try:
        yield
    finally:
        _collecting -= 1


def reset() -> None:
    global _dropped
    _records.clear()
    _stack().clear()
    _dropped = 0
    for k in counters:
        counters[k] = 0


def summary() -> Dict[str, Any]:
    """{"spans": {name: {calls, parents {name or "": calls}, host_ms,
    device_ms, self_host_ms, self_device_ms, host_syncs, collectives,
    encode_graph_replays, k6_value_rows, k6_value_slots, launches {wrapper: n}}},
    "counters": {the same counters, launches.<wrapper>}, "dropped"}.
    ``device_ms`` is the CUDA events' time on the stream the span began on
    (None where a record has none, as on a CPU); the self times are the
    span's less its direct children's.  Waits for the device once."""
    done = [r for r in _records if r.t1 is not None]
    if any(r.ev0 is not None for r in done):
        torch.cuda.synchronize()
    host = {id(r): (r.t1 - r.t0) * 1e-6 for r in done}
    dev = {id(r): (r.ev0.elapsed_time(r.ev1) if r.ev0 is not None else None) for r in done}
    child_host: Dict[int, float] = {}
    child_dev: Dict[int, float] = {}
    for r in done:
        if r.parent is not None and r.parent.t1 is not None:
            p = id(r.parent)
            child_host[p] = child_host.get(p, 0.0) + host[id(r)]
            if dev[id(r)] is not None:
                child_dev[p] = child_dev.get(p, 0.0) + dev[id(r)]
    names = [fn for _, fn in _WRAPPERS]
    spans: Dict[str, Dict[str, Any]] = {}
    for r in done:
        s = spans.setdefault(r.name, {"calls": 0, "parents": {}, "host_ms": 0.0, "device_ms": 0.0,
                                      "self_host_ms": 0.0, "self_device_ms": 0.0, **dict.fromkeys(counters, 0),
                                      "launches": {}})
        s["calls"] += 1
        parent = r.parent.name if r.parent is not None else ""
        s["parents"][parent] = s["parents"].get(parent, 0) + 1
        s["host_ms"] += host[id(r)]
        s["self_host_ms"] += host[id(r)] - child_host.get(id(r), 0.0)
        if dev[id(r)] is None or s["device_ms"] is None:
            s["device_ms"] = s["self_device_ms"] = None
        else:
            s["device_ms"] += dev[id(r)]
            s["self_device_ms"] += dev[id(r)] - child_dev.get(id(r), 0.0)
        for name, n in zip(counters, r.delta[0]):
            s[name] += n
        for name, n in zip(names, r.delta[1]):
            if n:
                s["launches"][name] = s["launches"].get(name, 0) + n
    totals = dict(counters)
    totals.update((f"launches.{name}", f.launches) for name, f in zip(names, _launch_fns()))
    return {"spans": spans, "counters": totals, "dropped": _dropped}
