"""``flops.py`` against ``torch.utils.flop_counter.FlopCounterMode`` on the
plain reference: the analytic render count (per-sample terms, S a
parameter, cf[16,4] from the same terms), and the meta-device counts of the
encode against the same count on real tensors."""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import REPO

sys.path.insert(0, REPO)

from portbench import flops, scenes  # noqa: E402
from portbench.drivers.render import _chunk_query  # noqa: E402

CONFIGS = ["coponerf-cf16x4-bf16", "coponerf-s64-bf16"]


def _model(name):
    return json.load(open(os.path.join(REPO, "portbench", "configs", name + ".json")))["model"]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("size,chunk", [(32, 256), (64, 4096)])
def test_render_flops_match_the_counted_reference(name, size, chunk):
    model = _model(name)
    ref = flops._reference(model, size)
    n = size * size
    b = flops._meta_batch(size, 1, n)
    with torch.no_grad():
        state = ref.encode(b)
        with FlopCounterMode(display=False) as fc:
            for a in range(0, n, chunk):
                ref.render(_chunk_query(b, a, min(a + chunk, n)), state, val=True)
    counted = fc.get_total_flops()
    # the analytic count leaves out the 4 x 4 pose products of the geometry
    assert abs(flops.render_flops(model, n, chunk) - counted) <= 1e-4 * counted


def test_stages_of_the_two_configurations():
    assert flops.stages(_model("coponerf-cf16x4-bf16")) == [16, 4]
    assert flops.stages(_model("coponerf-s64-bf16")) == [64]
    calls = flops.k2_calls(_model("coponerf-cf16x4-bf16"), 65536, 32768)
    assert [c[0] for c in calls] == [1048576, 1048576, 262144, 262144] * 2


def test_meta_counts_equal_counts_on_real_tensors():
    model = _model("coponerf-cf16x4-bf16")
    size = 32
    meta = flops.encode_flops(model, size)
    from portbench.reference.config import ModelConfig
    from portbench.reference.models import CoPoNeRF

    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in model.items()}
    ref = CoPoNeRF(ModelConfig(**dict(fields, compute_dtype="float32")), image_size=size)
    batch = scenes.make_batch(1, [0], size, 16, "cpu")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.encode(batch)
    assert meta == fc.get_total_flops() > 0


def test_train_flops_are_three_forwards():
    c = json.load(open(os.path.join(REPO, "portbench", "configs", "coponerf-s64-bf16.json")))
    f = flops.train_flops(c["model"], c["loss"], 32, 2, 16)
    assert f % 3 == 0 and f > 3 * flops.encode_flops(c["model"], 32, 2, True)
