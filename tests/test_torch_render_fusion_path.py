"""A fusion carried by the model (``CoPoNeRF(cfg, image_size, fusion=...)``)
on the port's normal path: the evaluation harness's ``make_renderer`` and
``evaluate`` on a model built with ``fusion="render_core"`` give what
chunked ``render()`` calls of such a model give, bit for bit; a model built
with the default renders unfused; the constructor refuses what K6 cannot
run; training renders ignore the model's fusion; and the ``test`` and
``render_path`` entries build their model with ``--fusion``.  Torch only, on the CPU, where K6's wrapper runs
its plain version, at the tiny sizes of ``tests/test_torch_slice_fused.py``.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from coponerf_tpu_torch import render_path
from coponerf_tpu_torch import test as test_entry
from coponerf_tpu_torch.config import ModelConfig
from coponerf_tpu_torch.data.synthetic import make_batch
from coponerf_tpu_torch.eval.harness import evaluate, make_renderer
from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
from coponerf_tpu_torch.models import coponerf as model_mod
from coponerf_tpu_torch.utils.init import init_weights

torch.set_num_threads(2)

IMG = 32
N_RAYS = 24
CHUNK = 10                      # three chunks, the last one partial
NARROW = dict(mask_upsample=IMG, npoints=8, ufc_layer_nums=(1, 1, 1))
CFG = ModelConfig(**NARROW, fast_sampling=True, compute_dtype="bfloat16")
KEYS = ("rgb", "depth_ray", "at_wt")


@pytest.fixture
def k6_calls(monkeypatch):
    """The number of ``render_core`` (K6) calls the model makes."""
    calls = []
    real = model_mod.render_core

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(model_mod, "render_core", counted)
    return calls


@pytest.fixture(scope="module")
def models():
    """The same weights built with ``fusion="render_core"`` and with none,
    a query of ``N_RAYS`` rays and the pair's inference encode."""
    fused = init_weights(CoPoNeRF(CFG, image_size=IMG, fusion="render_core"), seed=3).eval()
    plain = CoPoNeRF(CFG, image_size=IMG).eval()
    plain.load_state_dict(fused.state_dict())
    batch = batch_to_torch(make_batch(batch_size=1, image_size=IMG, n_rays=N_RAYS, seed=0)[0], "cpu")
    with torch.no_grad():
        state = plain.encode(batch)
    return fused, plain, batch, state


def _chunked(model, batch, state):
    """``model.render(val=True)`` over ``CHUNK``-ray chunks, the ``KEYS``
    assembled as the harness assembles them."""
    parts = {k: [] for k in KEYS}
    with torch.no_grad():
        for a in range(0, N_RAYS, CHUNK):
            q = dict(batch["query"], uv=batch["query"]["uv"][:, :, a:a + CHUNK],
                     rgb=batch["query"]["rgb"][:, :, a:a + CHUNK])
            out = model.render({"context": batch["context"], "query": q}, state, val=True)
            for k in KEYS:
                parts[k].append(out[k])
    return {k: torch.cat(v, dim=2 if k == "rgb" else 1) for k, v in parts.items()}


def test_make_renderer_runs_the_models_fusion(models, k6_calls):
    fused, plain, batch, state = models
    _, render_image = make_renderer(fused, CHUNK, keys=KEYS)
    got = render_image(batch, state, N_RAYS)
    assert len(k6_calls) == 3                        # one K6 call a chunk
    want = _chunked(plain.with_fusion("render_core"), batch, state)
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k


def test_default_model_renders_unfused(models, k6_calls):
    fused, plain, batch, state = models
    assert plain.fusion is None and fused.fusion == "render_core"
    _, render_image = make_renderer(plain, CHUNK, keys=KEYS)
    got = render_image(batch, state, N_RAYS)
    want = _chunked(plain, batch, state)
    assert not k6_calls
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k
    # a model's own fusion decides its renders, whichever model its weights came from
    assert torch.equal(_chunked(fused.with_fusion("attn_embed"), batch, state)["rgb"],
                       _chunked(plain.with_fusion("attn_embed"), batch, state)["rgb"])


def _eval_set():
    """The (batch, gt, overlap) item of one full-query synthetic scene."""
    b, g = make_batch(batch_size=1, image_size=IMG, n_rays=IMG * IMG, seed=100, full_query_image=True)
    return [({k: {kk: vv[0] for kk, vv in v.items()} for k, v in b.items()}, {k: v[0] for k, v in g.items()},
             np.float32(0.3))]


def test_evaluate_runs_the_models_fusion(models, k6_calls):
    fused, plain, *_ = models
    ds, kw = _eval_set(), dict(batch_size=1, chunk=IMG * IMG // 2, image_size=IMG, verbose=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")              # no LPIPS column
        got = evaluate(fused, ds, **kw)
        assert len(k6_calls) == 2                    # two chunks a scene
        want = evaluate(plain.with_fusion("render_core"), ds, **kw)
    assert len(k6_calls) == 4
    for b in got.BINS:
        assert set(got.metrics[b]) == set(want.metrics[b])
        for k in got.metrics[b]:
            if k != "rays_per_sec":
                assert got.metrics[b][k] == want.metrics[b][k], (b, k)


@pytest.mark.parametrize("change,fusion", [
    (dict(coarse_samples=6, fine_samples=4), "render_core"),
    (dict(compute_dtype="float32"), "render_core"),
    (dict(repeat_attention=False), "render_core"),
    (dict(fast_sampling=False, compute_dtype="float32"), "attn_embed"),
    ({}, "no_such_fusion"),
])
def test_construction_refuses_what_the_fusion_cannot_run(change, fusion):
    with pytest.raises(ValueError):
        CoPoNeRF(dataclasses.replace(CFG, **change), image_size=IMG, fusion=fusion)


def test_construction_takes_what_the_fusion_runs():
    assert CoPoNeRF(dataclasses.replace(CFG, coarse_samples=6, fine_samples=4), image_size=IMG,
                    fusion="attn_embed").fusion == "attn_embed"


@pytest.mark.parametrize("fusion", ["attn_embed", "render_core"])
def test_training_renders_ignore_the_models_fusion(models, k6_calls, fusion):
    _, plain, _, _ = models
    fused = plain.with_fusion(fusion)
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(fused.state_dict().values(), plain.state_dict().values()))
    batch = batch_to_torch(make_batch(batch_size=1, image_size=IMG, n_rays=16, seed=1)[0], "cpu")
    with torch.no_grad():
        state = plain.encode(batch, train=True)
        got = fused.render(batch, state, train=True)
        want = plain.render(batch, state, train=True)
    assert not k6_calls
    for k in ("rgb", "at_wt", "depth_ray"):
        assert torch.equal(got[k], want[k]), k


class _Built(Exception):
    pass


def test_test_entry_builds_its_model_with_the_fusion(monkeypatch):
    """``--fusion`` reaches the model the ``test`` entry builds (the build
    is stopped there); without ``--fast`` it is refused before anything
    loads."""
    import coponerf_tpu_torch.data.realestate as realestate
    import coponerf_tpu_torch.models as models_pkg

    built = []

    def record(cfg, image_size, fusion=None):
        built.append((cfg, fusion))
        raise _Built

    class Vis:
        def __init__(self, *a, **kw):
            self.cfg = type("cfg", (), {"image_size": IMG})

    monkeypatch.setattr(models_pkg, "CoPoNeRF", record)
    monkeypatch.setattr(realestate, "RealEstate10kVis", Vis)
    base = ["--data_root", "d", "--pose_root", "p.mat", "--checkpoint_path", "c.pt", "--allow_missing_lpips",
            "--device", "cpu"]
    for extra, fusion in ((["--fast", "--fusion", "render_core"], "render_core"), (["--fast"], None),
                          (["--fast", "--fusion", "attn_embed"], "attn_embed")):
        with pytest.raises(_Built):
            test_entry.main(base + extra)
        cfg, got = built.pop()
        assert got == fusion and cfg.fast_sampling and cfg.compute_dtype == "bfloat16"
    with pytest.raises(SystemExit):
        test_entry.main(base + ["--fusion", "render_core"])
    assert not built


def test_render_path_entry_renders_through_k6(models, tmp_path, monkeypatch, k6_calls):
    import coponerf_tpu_torch.utils.init as init

    monkeypatch.setattr(render_path, "ModelConfig", lambda **kw: ModelConfig(**{**kw, **NARROW}))
    weights = models[0].state_dict()

    def fixture_weights(model, seed):    # drawing seeded weights again takes seconds
        model.load_state_dict(weights)
        return model
    monkeypatch.setattr(init, "init_weights", fixture_weights)
    out = tmp_path / "frames"
    assert render_path.main(["--seed", "1", "--image_size", str(IMG), "--n_frames", "1", "--cf", "0,0",
                             "--fusion", "render_core", "--device", "cpu", "--out", str(out)]) == 0
    assert len(k6_calls) == 1 and (out / "frame_000.png").exists()
    for cf in ("16,4", "0,0 --exact"):
        with pytest.raises(SystemExit):
            render_path.main(["--seed", "1", "--cf", *cf.split(), "--fusion", "render_core", "--device", "cpu",
                              "--out", str(out)])
