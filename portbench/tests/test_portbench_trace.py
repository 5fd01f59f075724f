"""The readers of the program's spans and counters, on synthetic summaries
and on a checkout without the tracer, and the data-parallel driver at 2
gloo ranks on the CPU."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import pytest

from conftest import REPO, add_cell, run_cell

SPAN_METRICS = {
    # name: (spans summed, field, per call of)
    "encode.backbone_ms": (("encode.backbone",), "device_ms", "encode"),
    "encode.ufc_ms": (("encode.ufc",), "device_ms", "encode"),
    "encode.pose_ms": (("encode.pose",), "device_ms", "encode"),
    "render.stage_a_ms": (("render.stage_a",), "device_ms", "render_image"),
    "render.stage_b_ms": (("render.stage_b",), "device_ms", "render_image"),
    "render.attention_ms": (("render.attention",), "device_ms", "render_image"),
    "render.decode_ms": (("render.decode",), "device_ms", "render_image"),
    "host_ms_per_image": (("encode", "render_image"), "host_ms", "render_image"),
    "host_syncs_per_image": (("encode", "render_image"), "host_syncs", "render_image"),
    "train.forward_ms": (("train.forward",), "device_ms", "train_step"),
    "train.loss_ms": (("train.loss",), "device_ms", "train_step"),
    "train.backward_ms": (("train.backward",), "device_ms", "train_step"),
    "train.update_ms": (("train.update",), "device_ms", "train_step"),
    "host_ms_per_step": (("train_step",), "host_ms", "train_step"),
    "host_syncs_per_step": (("train_step",), "host_syncs", "train_step"),
    "train.allreduce_ms": (("train.allreduce",), "device_ms", "train_step"),
    "collectives_per_step": (("train_step",), "collectives", "train_step"),
}


def _reader(name):
    path = os.path.join(REPO, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _summary(device: bool):
    """Two encodes, three images and two steps; each span's fields from its name."""
    names = {n for spans, _, unit in SPAN_METRICS.values() for n in (*spans, unit)}
    calls = {"encode": 2, "render_image": 3, "train_step": 2}
    spans = {}
    for i, n in enumerate(sorted(names)):
        spans[n] = {"calls": calls.get(n, 6), "host_ms": 10.0 + i, "device_ms": 20.0 + i if device else None,
                    "host_syncs": 3 * i, "collectives": i}
    return {"spans": spans, "counters": {}, "dropped": 0}, calls


@pytest.mark.parametrize("device", [True, False])
@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_readers_on_a_synthetic_summary(name, device):
    summary, calls = _summary(device)
    names, field, unit = SPAN_METRICS[name]
    got = _reader(name)({"spans": summary})
    if field == "device_ms" and not device:
        assert got is None               # no CUDA events on a CPU
    else:
        assert got == pytest.approx(sum(summary["spans"][n][field] for n in names) / calls[unit])


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_readers_read_nothing_from_a_program_without_the_tracer(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "coponerf_tpu_torch.trace", None)    # its import then fails
    assert _reader(name)({}) is None
    summary, _ = _summary(True)
    del summary["spans"][SPAN_METRICS[name][0][0]]
    assert _reader(name)({"spans": summary}) is None


def test_the_benchmark_lists_each_reader():
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in SPAN_METRICS:
        assert listed[name]["source"] in ("program_span", "program_counter")
    cell = [w for w in bench["workloads"] if w["name"] == "train-s64-dp4x12"]
    assert cell and cell[0]["chips"] == 4 and cell[0]["config"] == "coponerf-s64-bf16"


def test_data_parallel_driver_at_two_gloo_ranks(bench_copy):
    """2 ranks of 2 pairs at 64^2: the window's rate, then a traced run with
    rank 0's spans and counters and the comparison with the 2-rank
    reference."""
    add_cell(bench_copy, "tiny-dp", "coponerf-s64-bf16",
             {"driver": "train_dp", "ranks": 2, "batch": 4, "rays": 64, "pool": 3, "compare_steps": 3,
              "trace_steps": 1},
             json.load(open(os.path.join(REPO, "portbench", "limits", "train-s64-dp4x12.json"))), 64)
    path = os.path.join(bench_copy, "BENCHMARK.json")
    bench = json.load(open(path))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "train-s64-dp4x12" in m.get("workloads", []):
            m["workloads"].append("tiny-dp")
    json.dump(bench, open(path, "w"))
    rc, line, err = run_cell(bench_copy, "tiny-dp", trace=0, seconds=1.0)
    assert rc == 0, err[-3000:]
    assert set(line["metrics"]) == {"train_pairs_per_s", "setup_s"}
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["checks"]["ranks_param_gap"]["value"] == 0.0   # every rank took the same updates
    rc, line, err = run_cell(bench_copy, "tiny-dp", trace=1, seconds=0.5)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    got = line["metrics"]
    # device times read nothing on a CPU; the host's and the counters do
    assert {"host_ms_per_step", "host_syncs_per_step", "collectives_per_step"} == set(got), got
    assert got["host_syncs_per_step"]["value"] > 2
    assert got["collectives_per_step"]["value"] > 2 and {"busy_s", "window_s"} <= set(line["device"])


NO_ALLREDUCE = """
from portbench.drivers import train_dp
_run = train_dp.run
train_dp.run = lambda ctx, mode="program", seeds=None: _run(ctx, "no_allreduce", seeds)
"""


def test_data_parallel_driver_fails_without_the_gradient_all_reduce(bench_copy):
    """Each rank stepping on its own share's gradient leaves the first
    step's forward and Adam's per-leaf steps as they were; only the ranks'
    parameters, which part, tell it."""
    add_cell(bench_copy, "tiny-dp", "coponerf-s64-bf16",
             {"driver": "train_dp", "ranks": 2, "batch": 4, "rays": 64, "pool": 3, "compare_steps": 3,
              "trace_steps": 1},
             json.load(open(os.path.join(REPO, "portbench", "limits", "train-s64-dp4x12.json"))), 64)
    rc, line, err = run_cell(bench_copy, "tiny-dp", trace=0, seconds=0.5, plant=NO_ALLREDUCE)
    assert rc == 0, err[-3000:]
    checks = line["checks"]
    assert line["correct"] is False, checks
    assert checks["ranks_param_gap"]["value"] > 10 * checks["ranks_param_gap"]["limit"], checks
