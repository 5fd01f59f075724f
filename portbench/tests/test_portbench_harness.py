"""The harness is driven by files: BENCHMARK.json keeps to the contract's
shapes, and a new configuration, traffic mix and per-layer metric come in
as added files and entries, with no existing file edited."""

from __future__ import annotations

import hashlib
import json
import os
import re

from conftest import REPO, add_cell, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _bench():
    return json.load(open(os.path.join(REPO, "BENCHMARK.json")))


def test_benchmark_json_keeps_to_the_contract():
    b = _bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    pb = os.path.join(REPO, "portbench")
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and os.path.isfile(os.path.join(REPO, c["file"]))
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["config"] in configs
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert os.path.isfile(os.path.join(pb, "traffic", w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(pb, "limits", w["name"] + ".json"))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.isfile(os.path.join(pb, "metrics", m["name"] + ".py"))
        assert set(m.get("workloads", [])) <= cells
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "bound" not in m and 1 <= len(m["layer"]) <= 200
    for w in b["workloads"]:   # every cell reports setup_s, another end-to-end and a per-layer metric
        mine = [m["name"] for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            if "__pycache__" not in p and not os.path.islink(p):
                out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_config_traffic_and_metric_are_added_files(bench_copy):
    before = _digests(os.path.join(bench_copy, "portbench"))
    pb = os.path.join(bench_copy, "portbench")
    # a new per-layer metric: its reader and its entry
    with open(os.path.join(pb, "metrics", "requests_seen.py"), "w") as f:
        f.write('def read(rec):\n    return float(rec["requests"]) if "requests" in rec else None\n')
    add_cell(bench_copy, "tiny-new", "coponerf-cf16x4-bf16",
             {"driver": "render", "pool": 1, "frames_per_scene": 2, "chunk": 256, "warmup_requests": 1,
              "trace_requests": 2, "compare_requests": 1, "reference_chunk": 256},
             json.load(open(os.path.join(pb, "limits", "tiny-path.json"))))
    bench = json.load(open(os.path.join(bench_copy, "BENCHMARK.json")))
    for m in bench["end_to_end"]:
        if "workloads" in m and "eval-cf16x4-pair" in m["workloads"]:
            m["workloads"].append("tiny-new")
    bench["per_layer"].append({"name": "requests_seen", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "request loop", "moves": "images_per_s",
                               "workloads": ["tiny-new"]})
    json.dump(bench, open(os.path.join(bench_copy, "BENCHMARK.json"), "w"))
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before     # nothing that existed was edited

    rc, line, err = run_cell(bench_copy, "tiny-new", trace=0)
    assert rc == 0, err[-3000:]
    assert list(line) == LINE_KEYS + ["checks"]
    assert set(line["metrics"]) == {"images_per_s", "image_p95_ms", "setup_s"}
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    rc, line, err = run_cell(bench_copy, "tiny-new", trace=1)
    assert rc == 0, err[-3000:]
    assert list(line) == LINE_KEYS + ["breakdown", "checks"]
    assert line["metrics"]["requests_seen"]["value"] >= 1
    assert {"busy_s", "window_s"} <= set(line["device"])
    for name, m in line["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"])
    for k, c in line["checks"].items():
        assert NAME.match(k) and c["value"] <= c["limit"]
    # the numbers compared are the last lines of standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


def test_a_traced_train_run_reports_its_per_layer_metrics(bench_copy):
    rc, line, err = run_cell(bench_copy, "tiny-train", trace=1)
    assert rc == 0, err[-3000:]
    assert list(line) == LINE_KEYS + ["breakdown", "checks"]
    assert "launches_per_step" in line["metrics"] and "idle_share.train" in line["metrics"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
