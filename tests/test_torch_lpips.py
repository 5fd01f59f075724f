"""The port's LPIPS-VGG (``coponerf_tpu_torch/eval/lpips.py``) against the
JAX package's ``LPIPSVGG`` (``coponerf_tpu/eval/lpips_jax.py``) on the
CPU, on random weights from the same ``make_random_weights`` file (the real
weights need a download).

Bounds: the distance at 1e-5 relative in both directions (f32 convs summed
in another order); zero (to 1e-7) for identical images; the weight files
the two packages write are equal array for array.
"""

import numpy as np
import pytest
import torch

from coponerf_tpu.eval import lpips_jax
from coponerf_tpu.eval import metrics as JM
from coponerf_tpu_torch.eval import lpips
from coponerf_tpu_torch.eval import metrics as TM

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("lpips")
    return lpips.make_random_weights(str(d / "port.npz"), seed=3), lpips_jax.make_random_weights(
        str(d / "jax.npz"), seed=3)


def _pair(seed, shape=(48, 48, 3), noise=0.2):
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape).astype(np.float32) * 2 - 1
    return a, np.clip(a + rng.randn(*shape).astype(np.float32) * noise, -1, 1)


def test_weight_files_match_jax(weights, tmp_path):
    port, ref = (np.load(p) for p in weights)
    assert sorted(port.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    rng = np.random.RandomState(1)
    vgg, in_ch = {}, 3
    for i, c in zip(lpips.CONV_IDX, [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]):
        vgg[f"features.{i}.weight"] = rng.randn(c, in_ch, 3, 3).astype(np.float32)
        vgg[f"features.{i}.bias"] = rng.randn(c).astype(np.float32)
        in_ch = c
    heads = {f"lin{k}.model.1.weight": rng.rand(1, c, 1, 1).astype(np.float32)
             for k, c in enumerate(lpips.CHANNELS)}
    lpips.convert_torch_lpips(heads, vgg, str(tmp_path / "p.npz"))
    lpips_jax.convert_torch_lpips(heads, vgg, str(tmp_path / "j.npz"))
    port, ref = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    for k in ref.files:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


@pytest.mark.parametrize("shape,noise,seed", [((48, 48, 3), 0.2, 0), ((2, 64, 40, 3), 0.05, 1),
                                              ((32, 32, 3), 0.8, 2)])
def test_lpips_matches_jax(weights, shape, noise, seed):
    """Both directions, one image or a batch (averaged as JAX averages)."""
    path = weights[0]
    a, b = _pair(seed, shape, noise)
    port, ref = lpips.LPIPSVGG.get(path), lpips_jax.LPIPSVGG.get(path)
    for x, y in ((a, b), (b, a)):
        got, want = port(x, y), ref(x, y)
        assert got == pytest.approx(want, rel=1e-5), (got, want)
    assert port(torch.from_numpy(a), torch.from_numpy(b)) == port(a, b)


def test_lpips_zero_for_identical_images(weights):
    a, _ = _pair(4, (40, 40, 3))
    assert abs(lpips.LPIPSVGG.get(weights[0])(a, a)) < 1e-7


def test_metrics_lpips_vgg_matches_jax(weights):
    """``eval/metrics.py:lpips_vgg`` on numpy inputs (the CPU) and on
    tensors (their device), against the JAX package's; None without weights."""
    a, b = _pair(5, (32, 32, 3))
    want = JM.lpips_vgg(a, b, weights[0])
    assert TM.lpips_vgg(a, b, weights[0]) == pytest.approx(want, rel=1e-5)
    assert TM.lpips_vgg(torch.from_numpy(a), torch.from_numpy(b), weights[0]) == pytest.approx(want, rel=1e-5)
    assert TM.lpips_vgg(a, b) is None
    assert lpips.LPIPSVGG.get(weights[0]) is lpips.LPIPSVGG.get(weights[0], "cpu")
