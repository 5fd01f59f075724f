"""Nothing a run loads is JAX or the JAX package, compared by whole top-level
names, and the reference imports nothing of the port."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from conftest import REPO, run_cell

REF = os.path.join(REPO, "portbench", "reference")


def test_reference_sources_import_nothing_of_the_port_or_jax():
    for d, _, files in os.walk(REF):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] in ("torch", "numpy", "portbench", "math", "typing", "dataclasses",
                                               "functools", "__future__"), (f, n)
                    assert not n.startswith("portbench.") or n.startswith("portbench.reference"), (f, n)


def test_reference_runs_without_loading_the_port():
    code = f"""
import sys, torch
sys.path[:0] = [{REPO!r}]
from portbench.reference.config import ModelConfig
from portbench.reference.models import CoPoNeRF
from portbench import scenes
m = CoPoNeRF(ModelConfig(fast_sampling=True, coarse_samples=4, fine_samples=2), image_size=32)
b = scenes.make_batch(3, [0], 32, 64, "cpu")
with torch.no_grad():
    m.render(b, m.encode(b), val=True)
bad = sorted({{k.split(".")[0] for k in sys.modules}} & {{"jax", "jaxlib", "flax", "coponerf_tpu", "coponerf_tpu_torch"}})
print(bad)
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from portbench import harness

    import types
    monkeypatch.setitem(sys.modules, "coponerf_tpu_torch_x", types.ModuleType("coponerf_tpu_torch_x"))
    monkeypatch.setitem(sys.modules, "jaxlike", types.ModuleType("jaxlike"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "coponerf_tpu.models", types.ModuleType("coponerf_tpu.models"))
    assert harness.forbidden_modules() == ["coponerf_tpu"]


def test_a_run_loads_no_jax(bench_copy):
    rc, line, err = run_cell(bench_copy, "tiny-pair")
    assert rc == 0 and line is not None, err[-3000:]
    # a run in which the JAX package got loaded prints no result
    plant = "import types; sys.modules['coponerf_tpu'] = types.ModuleType('coponerf_tpu')"
    rc, line, err = run_cell(bench_copy, "tiny-pair", plant=plant)
    assert rc != 0 and line is None and "coponerf_tpu" in err


def test_a_checkout_without_the_port_prints_no_result(bench_copy):
    os.remove(os.path.join(bench_copy, "coponerf_tpu_torch"))
    rc, line, err = run_cell(bench_copy, "tiny-pair")
    assert rc != 0 and line is None
