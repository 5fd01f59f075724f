"""The configuration ``coponerf-s64-rc-bf16`` and its driver
``drivers/render_fused.py`` on the CPU, where K6's wrapper runs its plain
version: the port's render through K6 against the plain reference
(``portbench/reference``) on seeded weights, K6's count (``flops_k6.py``)
against ``FlopCounterMode`` on K6's plain version, and the driver end to end
on a tiny cell of the configuration: correct and reporting
``render.core_ms``, and ``correct: false`` with the fp8 control or a K6
whose second attention round is left out in the program's place."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import REPO, add_cell, run_cell

sys.path.insert(0, REPO)

from portbench import flops_k6, scenes  # noqa: E402
from portbench.drivers.render import reference_render  # noqa: E402
from portbench.weights import load_weights  # noqa: E402

CONFIG = json.load(open(os.path.join(REPO, "portbench", "configs", "coponerf-s64-rc-bf16.json")))
SIZE = 32
S = 8

# K6 with its second attention round left out: z_sum = V * z1 (round 1's
# weighted latents alone), put in the program's place by rewriting the
# plain version's last line in memory (the kernel on a card is bypassed)
ROUND1_ONLY = """
import inspect, textwrap
import coponerf_tpu_torch.models.coponerf as model_mod
import coponerf_tpu_torch.ops.render_core as rc
src = textwrap.dedent(inspect.getsource(rc._plain_block))
assert src.count("return z_of(at2) + V * z1, at1") == 1
exec(src.replace("return z_of(at2) + V * z1, at1", "return V * z1, at1"), rc.__dict__)
model_mod.render_core = lambda *a: rc.render_core_plain(*a[:-3], S=a[-3], V=a[-2], n_rays=a[-1])
"""

CONTROL = """
import importlib
from portbench import calibrate
calibrate.plant(importlib.import_module("portbench.drivers.render_fused"), "control")
"""


def test_config_is_its_own_entry():
    """The configuration's entry names a source that, with its ``reduced``
    keys, no other configuration has, and its file states the same source:
    its model keys are ``coponerf-s64-bf16``'s, and what tells the two apart
    is the one-stage test render it runs through K6."""
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    ours = next(c for c in bench["configs"] if c["name"] == CONFIG["name"])
    assert ours["source"] == CONFIG["source"]
    others = [(c["source"], sorted(c["reduced"])) for c in bench["configs"] if c is not ours]
    assert (ours["source"], sorted(ours["reduced"])) not in others


def test_port_through_k6_renders_as_the_reference():
    """The port's fast bf16 render with ``fusion="render_core"`` against the
    f32 reference's single-stage render of ``S`` samples, both on the
    reference's encode, over 48 query rays.  The gap is the bf16 rounding
    of the sampled latents, of every product's operands (W1, the key and
    embed chains, the value maps) and of the weighted sums before the value
    products: relative RMS ~1e-2 (a bf16 step is 2^-8 of a value, summed
    over hundreds of products); an f32-exact render reads 1e-6."""
    from coponerf_tpu_torch.config import ModelConfig as PortConfig
    from coponerf_tpu_torch.models import CoPoNeRF as Port
    from coponerf_tpu_torch.models import SceneState

    from portbench.reference.config import ModelConfig
    from portbench.reference.models import CoPoNeRF

    kw = dict(CONFIG["model"], npoints=S, mask_upsample=SIZE)
    cpu = torch.device("cpu")
    port = load_weights(Port(PortConfig(**kw), image_size=SIZE, fusion=CONFIG["fusion"]), 5, cpu).eval()
    ref = load_weights(CoPoNeRF(ModelConfig(**dict(kw, compute_dtype="float32")), image_size=SIZE), 5, cpu).eval()
    batch = scenes.make_batch(5, [0], SIZE, 48, "cpu")
    with torch.no_grad():
        rs = ref.encode(batch)
        ps = SceneState(**{f.name: getattr(rs, f.name) for f in dataclasses.fields(rs)})
        out = port.render(batch, ps, val=True)
    rgb, at = reference_render(ref, batch, rs, 48, 16)
    gap = lambda a, b: float((a.float() - b).norm() / b.norm())
    assert gap(out["rgb"].reshape(-1, 3), rgb) < 3e-2
    assert gap(out["at_wt"], at) < 3e-2


def test_k6_count_matches_the_counted_plain_version():
    """``flops_k6`` against ``FlopCounterMode`` on ``render_core_plain`` at
    the published widths, 8 samples of 24 rays: the plain version computes
    W1's three point rows and the weighted sums elementwise, which the
    counter leaves out, so those terms are added to what it counts."""
    from coponerf_tpu_torch.bench_kernels import render_core_inputs
    from coponerf_tpu_torch.ops.render_core import WEIGHT_SHAPES, render_core_plain

    model, V, N = CONFIG["model"], 2, 24
    args = render_core_inputs(torch.device("cpu"), S, V, N)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        render_core_plain(*args[:-3], S=S, V=V, n_rays=N)
    t = flops_k6.per_token(model)
    elementwise = V * S * N * (t["W1 on the points, both sets"] + t["weighted sums, both rounds and sets"])
    assert flops_k6.k6_flops(model, N, S) == fc.get_total_flops() + elementwise
    assert flops_k6.weight_elems(model) == sum(math.prod(shape) for _, shape in WEIGHT_SHAPES)
    assert flops_k6.k6_calls(model, 65536, 32768) == [32768, 32768]
    assert flops_k6.k6_calls(dict(model, coarse_samples=16, fine_samples=4), 65536, 32768) == []


def _tiny_fused_cell(root: str) -> str:
    """A cell of the configuration at 32^2 and 8 samples a ray, with the
    eval cell's tiny traffic, ``eval-s64-pair``'s limits but for the flows'
    (conftest: an 8 x 8 grid's bf16 gaps read up to 0.01 at 32^2) and every
    metric that lists ``eval-s64-pair``."""
    name = "tiny-fused"
    limits = json.load(open(os.path.join(REPO, "portbench", "limits", "eval-s64-pair.json")))
    limits["flow_rel_rms"] = 0.03
    add_cell(root, name, "coponerf-s64-rc-bf16",
             {"driver": "render_fused", "pool": 2, "frames_per_scene": 1, "chunk": 512, "warmup_requests": 1,
              "trace_requests": 2, "compare_requests": 1, "reference_chunk": 512}, limits, SIZE)
    cfg_path = os.path.join(root, "portbench", "configs", name + "-cfg.json")
    cfg = json.load(open(cfg_path))
    cfg["model"].update(npoints=S, mask_upsample=SIZE)
    json.dump(cfg, open(cfg_path, "w"))
    bench_path = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(bench_path))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "eval-s64-pair" in m.get("workloads", []):
            m["workloads"].append(name)
    json.dump(bench, open(bench_path, "w"))
    return name


# the program's spans at the end of a run, on standard error
SPANS = """
import atexit, json
def _spans():
    from coponerf_tpu_torch import trace
    print("SPANS " + json.dumps(trace.summary()["spans"]), file=sys.stderr, flush=True)
atexit.register(_spans)
"""


def _reader(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location("reader", os.path.join(REPO, "portbench", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_render_core_reader_gives_device_ms_per_image():
    spans = {"render.core": {"calls": 8, "device_ms": 640.0}, "render_image": {"calls": 4, "device_ms": 960.0}}
    read = _reader("render.core_ms")
    assert read({"spans": {"spans": spans}}) == 160.0
    assert read({"spans": {"spans": dict(spans, **{"render.core": {"calls": 8, "device_ms": None}})}}) is None
    assert read({"spans": {"spans": {"render_image": spans["render_image"]}}}) is None   # a program without K6's span


def test_fused_driver_end_to_end(bench_copy):
    cell = _tiny_fused_cell(bench_copy)
    rc, line, err = run_cell(bench_copy, cell, trace=1, plant=SPANS)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True and line["failed"] == 0, (line, err[-3000:])
    assert set(line["checks"]) == {"rgb_rel_rms", "at_wt_l1", "z_rel_rms", "flow_rel_rms"}
    assert {"launches_per_image", "host_syncs_per_image", "idle_share.render"} <= set(line["metrics"])
    # K6 ran under its span inside render.attention, once a chunk of the
    # profiled requests (2 of 1024 rays in chunks of 512); on a CPU its
    # device time, and so render.core_ms and k6_roofline, are not there
    spans = json.loads([ln for ln in err.splitlines() if ln.startswith("SPANS ")][-1][len("SPANS "):])
    assert spans["render.core"]["calls"] == 2 * spans["render_image"]["calls"] == 4
    assert spans["render.core"]["parents"] == {"render.attention": 4}
    assert "render.core_ms" not in line["metrics"] and "k6_roofline" not in line["metrics"]
    for plant in (CONTROL, ROUND1_ONLY):
        rc, line, err = run_cell(bench_copy, cell, plant=plant)
        assert rc == 0 and line["correct"] is False, (plant, err[-3000:], line)
        print(plant.strip().splitlines()[-1], line["checks"])
