"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with tiny
cells added as files, and a way to run one of its cells on the CPU."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# small cells: the real configurations at 32^2 (render) and 64^2 (train: at
# 32^2 with 2 pairs the SSIM term's masks are too small for its gap to
# separate the fp8 control), with the real cells' limits but for the flows'
TINY = {
    "tiny-pair": ("coponerf-cf16x4-bf16", {"driver": "render", "pool": 2, "frames_per_scene": 1, "chunk": 512,
                                          "warmup_requests": 1, "trace_requests": 2, "compare_requests": 1,
                                          "reference_chunk": 512}, "eval-cf16x4-pair", 32),
    "tiny-path": ("coponerf-cf16x4-bf16", {"driver": "render", "pool": 2, "frames_per_scene": 3, "chunk": 512,
                                          "warmup_requests": 1, "trace_requests": 3, "compare_requests": 2,
                                          "reference_chunk": 512}, "path-cf16x4-30f", 32),
    "tiny-train": ("coponerf-s64-bf16", {"driver": "train", "batch": 4, "rays": 64, "pool": 3, "compare_steps": 3,
                                        "trace_steps": 1}, "train-s64-b12", 64),
}


def add_cell(root: str, name: str, config: str, traffic: dict, limits: dict, image_size: int = 32) -> None:
    """Add a cell to the benchmark copy at ``root`` by adding files and entries only."""
    pb = os.path.join(root, "portbench")
    cfg = json.load(open(os.path.join(pb, "configs", config + ".json")))
    cfg.update(name=name + "-cfg", image_size=image_size)
    json.dump(cfg, open(os.path.join(pb, "configs", name + "-cfg.json"), "w"))
    json.dump(traffic, open(os.path.join(pb, "traffic", name + ".json"), "w"))
    json.dump(limits, open(os.path.join(pb, "limits", name + ".json"), "w"))
    bench_path = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(bench_path))
    bench["configs"].append({"name": name + "-cfg", "source": "test", "file": f"portbench/configs/{name}-cfg.json",
                             "reduced": ["image_size"], "why": "a CPU test"})
    bench["workloads"].append({"name": name, "config": name + "-cfg", "traffic": name, "chips": 1, "why": "test"})
    like = TINY[name][2] if name in TINY else None
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and like in m["workloads"]:
            m["workloads"].append(name)
    json.dump(bench, open(bench_path, "w"))


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of BENCHMARK.json and portbench/ (the port linked beside it),
    with the tiny cells added."""
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "coponerf_tpu_torch"), os.path.join(root, "coponerf_tpu_torch"))
    for name, (config, traffic, real, size) in TINY.items():
        limits = json.load(open(os.path.join(REPO, "portbench", "limits", real + ".json")))
        if "flow_rel_rms" in limits:
            # at 32^2 the flows come from an 8 x 8 grid, whose bf16 gaps read
            # up to 0.01 (0.0022 at 256^2); the fp8 control reads 0.1
            limits["flow_rel_rms"] = 0.03
        add_cell(root, name, config, traffic, limits, size)
    return root


RUNNER = """
import sys, time
sys.path[:0] = [{root!r}]
from portbench import harness
{plant}
sys.exit(harness.main({argv!r}, time.perf_counter(), "cpu", {root!r}))
"""


def run_cell(root: str, workload: str, seed: int = 7, seconds: float = 0.5, trace: int = 0, plant: str = ""):
    """Run ``workload`` of the copy at ``root`` on the CPU in a new process,
    the look for a card skipped; ``plant`` is code run before it (a fault).
    Returns (exit code, the last line of standard output as JSON or None,
    standard error)."""
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    code = RUNNER.format(root=root, argv=argv, plant=plant)
    env = dict(os.environ, OMP_NUM_THREADS="4")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, env=env, timeout=900)
    lines = p.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p.returncode, line, p.stderr
