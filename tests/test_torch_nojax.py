"""The port runs without JAX: an inference render (also with both
``render(fusion=...)`` options), a train step, the latter also with
``fused_argmax=True``, the evaluation layer (harness, metrics, LPIPS,
overlap, scene readers, the native scene cache, loader, the ``test``
entry), a camera path, in-training validation with its summaries, the
``.pth`` import, the JAX ``.npz`` writer and reader, the ``train`` and
``render_path`` entries, the sampler
bench, the data-parallel layer (``parallel/``: a one-rank gloo mesh's train
step and ray-sharded render) and the multi-rank tests' rank functions
(``tests/torch_dist_helpers.py``) load no module of ``jax``, ``flax`` or
the JAX package ``coponerf_tpu``.  On CPU
tensors its kernel wrappers take the plain versions without counting a
launch."""

import dataclasses
import os
import subprocess
import sys

import torch

from coponerf_tpu_torch.config import ModelConfig
from coponerf_tpu_torch.data.synthetic import make_batch
from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
from coponerf_tpu_torch.ops.attn_embed import round1_logits, round2_logits
from coponerf_tpu_torch.ops.bilinear_sample import (bilinear_sample, corner_sample, grid_sample_window,
                                                    multilevel_sample, onehot_transpose_matmul)
from coponerf_tpu_torch.ops.render_core import render_core
from coponerf_tpu_torch.ops.soft_argmax import soft_argmax_bwd, soft_argmax_stats
from coponerf_tpu_torch.ops.split_matmul import split_dense_relu
from coponerf_tpu_torch.ops.weighted_sum import weighted_sum_smaj
from coponerf_tpu_torch.utils.init import init_weights

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import dataclasses
import sys
import torch
torch.set_num_threads(2)
import coponerf_tpu_torch
import coponerf_tpu_torch.test
import coponerf_tpu_torch.bench_kernels
import coponerf_tpu_torch.render_path
import coponerf_tpu_torch.train
import tempfile
from coponerf_tpu_torch.config import Config, LossConfig, ModelConfig, TrainConfig
from coponerf_tpu_torch.data import acid, fast_loader, loader, realestate, scene_dataset
from coponerf_tpu_torch.eval import harness, lpips, metrics, overlap, trajectory
from coponerf_tpu_torch.training import summaries, validation
from coponerf_tpu_torch.utils import cli, png, torch_import
from coponerf_tpu_torch.data.synthetic import make_batch
from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
from coponerf_tpu_torch.training import trainer
from coponerf_tpu_torch.utils.init import init_weights
cfg = ModelConfig(mask_upsample=32, npoints=4, ufc_layer_nums=(1, 1, 1), fast_sampling=True,
                  compute_dtype="bfloat16", coarse_samples=4, fine_samples=2)
batch, _ = make_batch(batch_size=1, image_size=32, n_rays=8, seed=0)
model = init_weights(CoPoNeRF(cfg, image_size=32).eval(), seed=0)
tb = batch_to_torch(batch, "cpu")
with torch.no_grad():
    state = model.encode(tb)
    out = model.render(tb, state, val=True)
    assert torch.isfinite(out["rgb"]).all()
    out = model.render(tb, state, val=True, fusion="attn_embed")
    assert torch.isfinite(out["rgb"]).all()
    single = CoPoNeRF(dataclasses.replace(cfg, coarse_samples=0, fine_samples=0), image_size=32).eval()
    single.load_state_dict(model.state_dict())
    out = single.render(tb, state, val=False, fusion="render_core")
    assert torch.isfinite(out["rgb"]).all()
eb, eg = make_batch(batch_size=1, image_size=32, n_rays=32 * 32, seed=2, full_query_image=True)
item = ({k: {kk: vv[0] for kk, vv in v.items()} for k, v in eb.items()}, {k: v[0] for k, v in eg.items()}, 1.0)
acc = harness.evaluate(model, [item], batch_size=1, chunk=512, image_size=32, verbose=False)
assert len(acc.metrics["all"]["psnr"]) == 1
assert overlap.compute_overlap_table(model, [item]).shape == (1, 1)
tcfg = Config(model=cfg, loss=LossConfig(pose=True, cycle=True, ssim=True), train=TrainConfig(lr=1e-4))
state = trainer.create_train_state(tcfg, 32, "cpu", model=model)
metrics = trainer.train_step(state, batch_to_torch(make_batch(batch_size=2, image_size=32, n_rays=8, seed=1)[0], "cpu"), tcfg)
assert state.updates == 1 and all(torch.isfinite(v) for v in metrics.values())
from coponerf_tpu_torch.training.checkpoint import load_weights
from coponerf_tpu_torch.utils import jax_checkpoint
with tempfile.TemporaryDirectory() as d:
    path = jax_checkpoint.save(d, state, step=state.step)
    back = trainer.create_train_state(tcfg, 32, "cpu", model=CoPoNeRF(cfg, image_size=32))
    jax_checkpoint.restore_into(back, path)
    assert (back.step, back.updates) == (state.step, state.updates)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, back.model.state_dict()[k]), k
    load_weights(CoPoNeRF(cfg, image_size=32), path)
class Logger:
    def __init__(self):
        self.tags = []
    def log(self, step, m):
        self.tags += list(m)
    def log_image(self, step, tag, img):
        self.tags.append(tag)
vlog = Logger()
vb = make_batch(batch_size=1, image_size=32, n_rays=32 * 32, seed=3, full_query_image=True)
validation.make_val_fn(tcfg, [vb], chunk=512, image_size=32)(state, 1, vlog)
assert "val_img_loss" in vlog.tags and "val_epipolar_pred" in vlog.tags, vlog.tags
model.eval()
frames = trajectory.render_trajectory(model, batch, n_frames=2, image_size=32, chunk=512)
assert frames.shape == (2, 32, 32, 3)
with tempfile.TemporaryDirectory() as d:
    acc = harness.evaluate(model, [item], batch_size=1, chunk=512, image_size=32, verbose=False,
                           lpips_weights=lpips.make_random_weights(d + "/lpips.npz"))
    assert len(acc.metrics["all"]["lpips"]) == 1
fcfg = dataclasses.replace(tcfg, model=dataclasses.replace(cfg, fused_argmax=True))
fstate = trainer.create_train_state(fcfg, 32, "cpu", model=init_weights(CoPoNeRF(fcfg.model, image_size=32), seed=0))
metrics = trainer.train_step(fstate, batch_to_torch(make_batch(batch_size=2, image_size=32, n_rays=8, seed=1)[0], "cpu"), fcfg)
assert fstate.updates == 1 and all(torch.isfinite(v) for v in metrics.values())
import coponerf_tpu_torch.parallel
from coponerf_tpu_torch.parallel import launch, mesh as pmesh, render as prender
sys.path.insert(0, "tests")
import torch_dist_helpers
with tempfile.TemporaryDirectory() as d:
    pmesh.init_distributed("gloo", 0, 1, f"file://{d}/rendezvous")
    try:
        mesh = pmesh.make_mesh((1, -1), ("data", "rays"))
        metrics = trainer.train_step(state, batch_to_torch(make_batch(batch_size=2, image_size=32, n_rays=8, seed=1)[0], "cpu"), tcfg, mesh=mesh)
        assert state.updates == 2 and all(torch.isfinite(v) for v in metrics.values())
        model.eval()
        with torch.no_grad():
            out = prender.render_ray_sharded(model, tb, model.encode(tb), mesh, chunk=4)
        assert out["rgb"].shape == (1, 1, 8, 3)
    finally:
        torch.distributed.destroy_process_group()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print("JAX_MODULES", bad)
ref = sorted(m for m in sys.modules if m.split(".")[0] == "coponerf_tpu")
print("REFERENCE_MODULES", ref)
sys.exit(1 if bad or ref else 0)
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "JAX_MODULES []" in res.stdout
    assert "REFERENCE_MODULES []" in res.stdout, res.stdout


def test_cpu_tensors_take_the_plain_versions():
    """Inference (unfused and with both fusions) and a train-mode forward
    and backward on CPU tensors, the latter also with ``fused_argmax=True``,
    leave every kernel's launch count at zero (K1 and its corner-id entry,
    K2, K3, K4, K5's forward and backward, K6, K7's two rounds, K8a and
    K8b)."""
    cfg = ModelConfig(mask_upsample=32, npoints=4, ufc_layer_nums=(1, 1, 1), fast_sampling=True,
                      compute_dtype="bfloat16", coarse_samples=4, fine_samples=2)
    batch, _ = make_batch(batch_size=1, image_size=32, n_rays=8, seed=1)
    model = init_weights(CoPoNeRF(cfg, image_size=32).eval(), seed=1)
    tb = batch_to_torch(batch, "cpu")
    counters = (bilinear_sample, corner_sample, split_dense_relu, weighted_sum_smaj, onehot_transpose_matmul,
                soft_argmax_stats, soft_argmax_bwd, round1_logits, round2_logits, render_core, multilevel_sample,
                grid_sample_window)
    before = tuple(c.launches for c in counters)
    with torch.no_grad():
        state = model.encode(tb)
        out = model.render(tb, state, val=True)
        assert torch.isfinite(out["rgb"]).all()
        out = model.render(tb, state, val=True, fusion="attn_embed")
        assert torch.isfinite(out["rgb"]).all()
        single = CoPoNeRF(dataclasses.replace(cfg, coarse_samples=0, fine_samples=0), image_size=32).eval()
        single.load_state_dict(model.state_dict())
        out = single.render(tb, state, val=True, fusion="render_core")
        assert torch.isfinite(out["rgb"]).all()
    out = model(tb, val=False, train=True)
    out["rgb"].sum().backward()
    assert model.feature_cost_aggregation.proj_feat_0.Dense_0.weight.grad is not None
    fused = init_weights(CoPoNeRF(dataclasses.replace(cfg, fused_argmax=True), image_size=32), seed=1)
    out = fused(tb, val=False, train=True)
    (out["rgb"].sum() + out["flow"][0].square().sum()).backward()
    assert fused.feature_cost_aggregation.proj_feat_0.Dense_0.weight.grad is not None
    after = tuple(c.launches for c in counters)
    assert before == after == (0,) * 12
