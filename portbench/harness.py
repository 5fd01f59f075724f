"""The benchmark's driver-independent part: it finds a cell's files by the
names in ``BENCHMARK.json``, runs the cell's driver once, reads each metric
with its reader, judges the comparison against its limits and prints the
result line.

Files found by name, so that a new cell, configuration, traffic mix or
metric is a new file and an entry, and nothing that exists is edited:
  portbench/configs/<config>.json   the configuration (``file`` in BENCHMARK.json)
  portbench/traffic/<traffic>.json  a traffic mix: ``driver`` and its parameters
  portbench/drivers/<driver>.py     ``run(ctx) -> Outcome``
  portbench/metrics/<metric>.py     ``read(rec) -> float | None``
  portbench/limits/<workload>.json  the limit of each number the driver compares
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
# whole top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "coponerf_tpu")


@dataclasses.dataclass
class Context:
    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    device: Any                      # torch.device
    t0: float                        # time.perf_counter() at process start
    log: Any = None                  # print to standard error


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    rec: Dict[str, Any]              # what the readers read
    checks: Dict[str, float]         # each number compared, by name
    memory_peak_bytes: int
    breakdown: Optional[Dict[str, List]] = None


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def _file(*parts: str) -> str:
    path = os.path.join(PKG, *parts)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    return path


def load_cell(name: str, root: str = ROOT):
    """(BENCHMARK.json, the workload entry, its config file, its traffic file)."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = [w for w in bench["workloads"] if w["name"] == name]
    if len(cells) != 1:
        raise KeyError(f"workload {name!r} is not in BENCHMARK.json")
    cell = cells[0]
    configs = [c for c in bench["configs"] if c["name"] == cell["config"]]
    if len(configs) != 1:
        raise KeyError(f"config {cell['config']!r} is not in BENCHMARK.json")
    config = load_json(os.path.join(root, configs[0]["file"]))
    traffic = load_json(_file("traffic", cell["traffic"] + ".json"))
    return bench, cell, config, traffic


def cell_metrics(bench: Dict, cell: Dict, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones untraced,
    its per-layer ones traced (those listing it, or listing no cells)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell["name"] in m.get("workloads", [cell["name"]])]


def read_metric(name: str, rec: Dict[str, Any]) -> Optional[float]:
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_").replace("-", "_"),
                                                  _file("metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def result(outcome: Outcome, metrics: List[Dict], limits: Dict[str, float], device: Dict,
           trace: bool) -> Dict[str, Any]:
    """The result line's object; ``checks`` comes last."""
    missing = sorted(set(outcome.checks) ^ set(limits))
    if missing:
        raise KeyError(f"numbers compared and limits differ: {missing}")
    checks = {k: {"value": v, "limit": limits[k]} for k, v in outcome.checks.items()}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    values = {}
    for m in metrics:
        v = read_metric(m["name"], outcome.rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": values, "device": device}
    if trace and outcome.breakdown is not None:
        line["breakdown"] = outcome.breakdown
    line["checks"] = checks
    return line


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: List[str], t0: float, device_type: str = "cuda", root: str = ROOT) -> int:
    """One run.  ``device_type="cpu"`` skips the look for a card (tests)."""
    args = parse(argv)
    bench, cell, config, traffic = load_cell(args.workload, root)
    limits = load_json(_file("limits", cell["name"] + ".json"))
    import torch

    log(f"set-up: torch imported at {time.perf_counter() - t0:.3f} s")
    if device_type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            log(f"portbench: the cell needs {cell['chips']} CUDA device(s), {n} found")
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device(device_type)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    ctx = Context(workload=cell["name"], seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  cell=cell, config=config, traffic=traffic, device=device, t0=t0, log=log)
    outcome = driver.run(ctx)
    bad = forbidden_modules()
    if bad:
        log(f"portbench: the run loaded {bad}; no result")
        return 3
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
            "count": cell["chips"], "memory_peak_bytes": outcome.memory_peak_bytes}
    if ctx.trace:
        info["busy_s"] = outcome.rec["profile"]["busy_s"]
        info["window_s"] = outcome.rec["profile"]["window_s"]
    line = result(outcome, cell_metrics(bench, cell, ctx.trace), limits, info, ctx.trace)
    for k, c in line["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0
