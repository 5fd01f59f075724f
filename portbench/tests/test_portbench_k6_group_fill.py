"""The k6_group_fill reader on synthetic summaries and on a checkout without
the tracer."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import pytest

from conftest import REPO


def _read(rec):
    path = os.path.join(REPO, "portbench", "metrics", "k6_group_fill.py")
    spec = importlib.util.spec_from_file_location("reader_k6_group_fill", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


@pytest.mark.parametrize("core, expected", [
    ({"calls": 48, "k6_value_rows": 48 * 32768, "k6_value_slots": 48 * 33792}, 100.0 * 32768 / 33792),
    ({"calls": 48, "host_syncs": 0}, None),                               # a program without the counters
    ({"calls": 2, "k6_value_rows": 0, "k6_value_slots": 0}, None),        # K6's plain version: no launch
    (None, None),                                                         # no render.core span
])
def test_k6_group_fill_reader(core, expected, monkeypatch):
    """k6_group_fill: the rays over the row slots of K6's value products in
    the render.core spans; None where they are not counted."""
    spans = {"render_image": {"calls": 24}}
    if core is not None:
        spans["render.core"] = core
    got = _read({"spans": {"spans": spans, "counters": {}, "dropped": 0}})
    assert got == (None if expected is None else pytest.approx(expected))
    monkeypatch.setitem(sys.modules, "coponerf_tpu_torch.trace", None)    # a checkout without the tracer
    assert _read({}) is None


def test_k6_group_fill_is_listed():
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    entry = {m["name"]: m for m in bench["per_layer"]}["k6_group_fill"]
    assert entry["source"] == "program_counter" and entry["moves"] == "images_per_s"
    assert entry["workloads"] == ["eval-s64-pair"]
