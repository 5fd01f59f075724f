"""The port runs without JAX, and on CPU tensors its kernel wrappers take
the plain versions without counting a launch."""

import os
import subprocess
import sys

import torch

from coponerf_tpu_torch.config import ModelConfig
from coponerf_tpu_torch.data.synthetic import make_batch
from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
from coponerf_tpu_torch.ops.bilinear_sample import bilinear_sample
from coponerf_tpu_torch.ops.split_matmul import split_dense_relu
from coponerf_tpu_torch.ops.weighted_sum import weighted_sum_smaj
from coponerf_tpu_torch.utils.init import init_weights

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import sys
import torch
torch.set_num_threads(2)
import coponerf_tpu_torch
from coponerf_tpu_torch.config import ModelConfig
from coponerf_tpu_torch.data.synthetic import make_batch
from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
from coponerf_tpu_torch.utils.init import init_weights
cfg = ModelConfig(mask_upsample=32, npoints=4, ufc_layer_nums=(1, 1, 1), fast_sampling=True,
                  compute_dtype="bfloat16", coarse_samples=4, fine_samples=2)
batch, _ = make_batch(batch_size=1, image_size=32, n_rays=8, seed=0)
model = init_weights(CoPoNeRF(cfg, image_size=32).eval(), seed=0)
tb = batch_to_torch(batch, "cpu")
out = model.render(tb, model.encode(tb), val=True)
assert torch.isfinite(out["rgb"]).all()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print("JAX_MODULES", bad)
# of the reference package, only its framework-free config and data modules
ref = sorted(m for m in sys.modules if m.split(".")[0] == "coponerf_tpu")
print("REFERENCE_MODULES", ref)
sys.exit(1 if bad else 0)
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "JAX_MODULES []" in res.stdout
    allowed = "['coponerf_tpu', 'coponerf_tpu.config', 'coponerf_tpu.data', 'coponerf_tpu.data.synthetic']"
    assert f"REFERENCE_MODULES {allowed}" in res.stdout, res.stdout


def test_cpu_tensors_take_the_plain_versions():
    cfg = ModelConfig(mask_upsample=32, npoints=4, ufc_layer_nums=(1, 1, 1), fast_sampling=True,
                      compute_dtype="bfloat16", coarse_samples=4, fine_samples=2)
    batch, _ = make_batch(batch_size=1, image_size=32, n_rays=8, seed=1)
    model = init_weights(CoPoNeRF(cfg, image_size=32).eval(), seed=1)
    tb = batch_to_torch(batch, "cpu")
    before = (bilinear_sample.launches, split_dense_relu.launches, weighted_sum_smaj.launches)
    out = model.render(tb, model.encode(tb), val=True)
    assert torch.isfinite(out["rgb"]).all()
    after = (bilinear_sample.launches, split_dense_relu.launches, weighted_sum_smaj.launches)
    assert before == after == (0, 0, 0)
