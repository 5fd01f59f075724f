"""The port's evaluation harness (``coponerf_tpu_torch/eval/``) on the CPU:
chunked render assembly, pruning, the tail policy, and ``evaluate`` and
``compute_overlap_table`` held to the JAX package's on two tiny synthetic
scenes (IMG 32, exact config, npoints 8, weights converted from the JAX
package's ``fast_init``).

Bounds: the assembled outputs against a single render at 1e-5 (chunks of
another size sum in another order in the CPU matmuls); PSNR, SSIM and the
pose errors against JAX at 1e-4 absolute (the exact slice matches JAX at
1e-4, ``tests/test_torch_slice_exact.py``); pruned against unpruned
metrics at 1e-6.  The JAX reference is computed once per module.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coponerf_tpu.config import ModelConfig as JaxModelConfig
from coponerf_tpu.data.synthetic import make_batch
from coponerf_tpu.eval.harness import evaluate as jax_evaluate
from coponerf_tpu.eval.overlap import compute_overlap_table as jax_overlap_table
from coponerf_tpu.models import CoPoNeRF as JaxCoPoNeRF
from coponerf_tpu.utils.fast_init import fast_init
from coponerf_tpu_torch.config import ModelConfig
from coponerf_tpu_torch.eval.harness import _RAY_AXIS, evaluate, make_renderer
from coponerf_tpu_torch.eval.overlap import compute_overlap_table
from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
from coponerf_tpu_torch.utils.convert import convert

torch.set_num_threads(2)

IMG = 32
CFG_KW = dict(mask_upsample=IMG, npoints=8, ufc_layer_nums=(1, 1, 1))
METRICS = ("psnr", "mse", "ssim", "rot", "trans", "angle_trans")


class _TinyEvalSet:
    """(batch, gt, overlap) items of full-query synthetic scenes."""

    def __init__(self, n):
        self.items = []
        for i in range(n):
            b, g = make_batch(batch_size=1, image_size=IMG, n_rays=IMG * IMG, seed=100 + i,
                              full_query_image=True)
            self.items.append(({k: {kk: vv[0] for kk, vv in v.items()} for k, v in b.items()},
                               {k: v[0] for k, v in g.items()}, np.float32(0.3 + 0.4 * i)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the LPIPS column is intentionally absent
        return fn(*args, verbose=False, **kwargs)


@pytest.fixture(scope="module")
def setup():
    batch_np, _ = make_batch(batch_size=1, image_size=IMG, n_rays=16, seed=0)
    jm = JaxCoPoNeRF(JaxModelConfig(**CFG_KW))
    variables = fast_init(jm, jax.tree.map(jnp.asarray, batch_np), val=False, train=False)
    port = CoPoNeRF(ModelConfig(**CFG_KW), image_size=IMG).eval()
    port.load_state_dict(convert(jax.tree.map(np.asarray, variables)), strict=True)
    ds = _TinyEvalSet(2)
    common = dict(batch_size=1, chunk=IMG * IMG // 2, image_size=IMG)
    ref = {
        "acc": _quiet(jax_evaluate, jm, variables, ds, **common),
        "overlap": jax_overlap_table(jm, variables, ds),
    }
    return port, ds, common, ref


@pytest.mark.parametrize("key", METRICS)
def test_evaluate_matches_jax(setup, key):
    port, ds, common, ref = setup
    acc = _quiet(evaluate, port, ds, **common)
    assert sorted(acc.metrics) == sorted(ref["acc"].metrics)
    for b in acc.BINS:
        np.testing.assert_allclose(acc.metrics[b][key], ref["acc"].metrics[b][key], atol=1e-4, rtol=0,
                                   err_msg=f"{b}/{key}")


def test_overlap_table_matches_jax(setup):
    port, ds, _, ref = setup
    got = compute_overlap_table(port, ds)
    assert got.shape == ref["overlap"].shape == (2, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref["overlap"], atol=1e-6)


def test_renderer_assembles_every_key(setup):
    """Every ``_RAY_AXIS`` output assembled over 300-ray chunks (the last
    one partial) equals the single-shot val render."""
    port, ds, _, _ = setup
    batch = batch_to_torch({k: {kk: vv[None] for kk, vv in v.items()} for k, v in ds[0][0].items()}, "cpu")
    encode, render_image = make_renderer(port, chunk=300, keys=tuple(_RAY_AXIS))
    state = encode(batch)
    assembled = render_image(batch, state, IMG * IMG)
    assert render_image.last_n_rendered == IMG * IMG
    with torch.no_grad():
        direct = port.render(batch, state, val=True)
    for k in _RAY_AXIS:
        a, d = assembled[k], direct[k]
        assert a.shape == d.shape, k
        np.testing.assert_allclose(a.float().numpy(), d.float().numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
    w = assembled["at_wt"].reshape(1, 2, IMG * IMG, CFG_KW["npoints"]).sum(dim=(1, 3))
    np.testing.assert_allclose(w.numpy(), 1.0, atol=1e-5)


def _rotated_batch(batch_np, deg=60.0):
    """The query camera turned about the up axis: most rays leave both
    context frusta (a sparse valid mask)."""
    b = {k: {kk: np.array(vv) for kk, vv in v.items()} for k, v in batch_np.items()}
    th = np.deg2rad(deg)
    R = np.eye(4, dtype=np.float32)
    R[0, 0], R[0, 2], R[2, 0], R[2, 2] = np.cos(th), np.sin(th), -np.sin(th), np.cos(th)
    b["query"]["cam2world"] = b["query"]["cam2world"] @ R
    return batch_to_torch(b, "cpu")


def test_pruned_render_matches_unpruned(setup):
    """On a sparse-mask scene ``prune_invalid`` renders fewer rays, gives
    the unpruned rgb (invalid rays white either way) and the unpruned aux
    outputs on the valid rays; the mask is the render's own valid_mask."""
    port, _, _, _ = setup
    n_rays = 16
    b = _rotated_batch(make_batch(batch_size=1, image_size=IMG, n_rays=n_rays, seed=0)[0])
    keys = ("rgb", "depth_ray", "at_wt")
    encode, render_plain = make_renderer(port, chunk=8, keys=keys)
    _, render_pruned = make_renderer(port, chunk=8, keys=keys, prune_invalid=True)
    state = encode(b)
    mask = port.valid_ray_mask(b, state, val=True).numpy()
    with torch.no_grad():
        vm = port.render(b, state, val=True)["valid_mask"][..., 0].numpy() > 0
    np.testing.assert_array_equal(mask, vm)
    n_valid = int(mask.sum(axis=-1).max())
    assert 0 < n_valid < n_rays - 8, f"geometry no longer sparse: {n_valid}/{n_rays}"

    plain = render_plain(b, state, n_rays)
    pruned = render_pruned(b, state, n_rays)
    assert render_pruned.last_n_rendered < n_rays
    np.testing.assert_allclose(pruned["rgb"].numpy(), plain["rgb"].numpy(), rtol=1e-5, atol=1e-5)
    valid = mask[0]
    np.testing.assert_allclose(pruned["depth_ray"].numpy()[0, valid], plain["depth_ray"].numpy()[0, valid],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pruned["depth_ray"].numpy()[0, ~valid], 0.0)
    at_p = pruned["at_wt"].numpy().reshape(2, n_rays, -1)
    at_u = plain["at_wt"].numpy().reshape(2, n_rays, -1)
    np.testing.assert_allclose(at_p[:, valid], at_u[:, valid], rtol=1e-5, atol=1e-5)


def test_evaluate_pruned_matches_unpruned(setup):
    port, ds, common, _ = setup
    plain = _quiet(evaluate, port, ds, **common)
    pruned = _quiet(evaluate, port, ds, prune_invalid=True, **common)
    for k in METRICS:
        np.testing.assert_allclose(plain.metrics["all"][k], pruned.metrics["all"][k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_evaluate_tail_policy(setup):
    """drop_last=True (default, the reference's DataLoader) skips the
    n % batch_size tail scenes; drop_last=False evaluates them too, and the
    shared scenes carry the same metrics under either policy."""
    port, _, common, _ = setup
    ds = _TinyEvalSet(3)
    kw = dict(common, batch_size=2)
    acc = _quiet(evaluate, port, ds, **kw)
    acc_all = _quiet(evaluate, port, ds, drop_last=False, **kw)
    assert len(acc.metrics["all"]["psnr"]) == 2
    assert len(acc_all.metrics["all"]["psnr"]) == 3
    np.testing.assert_allclose(acc.metrics["all"]["psnr"], acc_all.metrics["all"]["psnr"][:2], rtol=1e-6)
