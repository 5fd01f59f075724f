"""The comparison that decides ``correct`` fails its control and the faults
a cell can have: the whole run driven on the CPU at 32^2 with the real
cells' limits, the look for a card skipped and the timed path broken
underneath.  The control and the faults' readings at the cells' own sizes
come from ``calibrate.py`` on the card (``PERF.md``)."""

from __future__ import annotations

from conftest import run_cell

CONTROL = """
import importlib
from portbench import calibrate
calibrate.plant(importlib.import_module("portbench.drivers.{driver}"), "{mode}")
"""

ALTERED_RGB = """
import portbench.drivers.render as d
_make = d.make_renderer
def make_renderer(model, chunk):
    encode, render_image = _make(model, chunk)
    def altered(batch, state, n):
        out = dict(render_image(batch, state, n))
        out["rgb"] = out["rgb"] * 1.1          # an answer altered where it is produced
        return out
    return encode, altered
d.make_renderer = make_renderer
"""

UNCHANGED_STATE = """
import portbench.drivers.train as d
_step = d.step
def step(state, batch, cfg):              # a step that returns its state unchanged
    before = [p.detach().clone() for p in state.model.parameters()]
    m = _step(state, batch, cfg)
    with torch.no_grad():
        for p, b in zip(state.model.parameters(), before):
            p.copy_(b)
    return m
import torch
d.step = step
"""


def test_render_cell_program_passes_and_its_control_and_fault_fail(bench_copy):
    for workload in ("tiny-path",):
        rc, line, err = run_cell(bench_copy, workload)
        assert rc == 0 and line["correct"] is True, (err[-3000:], line)
        rc, line, err = run_cell(bench_copy, workload, plant=CONTROL.format(driver="render", mode="control"))
        assert rc == 0 and line["correct"] is False, (err[-3000:], line)
        rc, line, err = run_cell(bench_copy, workload, plant=ALTERED_RGB)
        assert rc == 0 and line["correct"] is False, (err[-3000:], line)


def test_train_cell_program_passes_and_its_control_and_faults_fail(bench_copy):
    rc, line, err = run_cell(bench_copy, "tiny-train")
    assert rc == 0 and line["correct"] is True, (err[-3000:], line)
    for plant in (CONTROL.format(driver="train", mode="control"), CONTROL.format(driver="train", mode="half_batch"),
                  UNCHANGED_STATE):
        rc, line, err = run_cell(bench_copy, "tiny-train", plant=plant)
        assert rc == 0 and line["correct"] is False, (plant, err[-3000:], line)
