"""The ``fused_argmax=True`` configuration, in which the UFC extracts both
flows through K5 (``ops/soft_argmax.py``; its plain versions on the CPU).

- The exact-config encode (IMG 32, UFC (1, 1, 1)) against the JAX
  package's with the same flag (Pallas interpreted): the flows and
  mappings, the relative pose and the UFC's fine correlation volume ``c``
  at atol/rtol 1e-4, as ``tests/test_torch_slice_exact.py`` holds the
  unfused encode (readings: flows 6.7e-6 px, ``c`` 3.6e-7, pose 4.4e-6).
- The port's fused encode against its unfused one from the same weights:
  ``c`` and the pose do not depend on the flow extraction and are equal;
  the flows agree to 1e-5 px (reading: 0, since on the CPU the plain
  versions compute the unfused formula; JAX's own fused and unfused flows
  differ by 6.6e-7 px at this size).
- One whole exact-config train step against JAX's ``make_train_step`` with
  the same flag (batch seed 0), at ``tests/test_torch_train_exact.py``'s
  bounds.

The JAX references are computed once per module.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from coponerf_tpu.config import ModelConfig as JaxModelConfig
from coponerf_tpu.data.synthetic import make_batch
from coponerf_tpu.models import CoPoNeRF as JaxCoPoNeRF
from coponerf_tpu.utils.fast_init import fast_init
from coponerf_tpu_torch.config import ModelConfig
from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
from coponerf_tpu_torch.utils.convert import convert
from torch_step_helpers import (
    check_exact_gradients,
    check_exact_losses_and_grad_norm,
    check_exact_updates_and_bn_stats,
    run_both,
)

torch.set_num_threads(2)

IMG = 32
CFG_KW = dict(mask_upsample=IMG, npoints=8, ufc_layer_nums=(1, 1, 1))
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _port_encode(fused, weights, tb):
    """(SceneState, the UFC's c) of a port encode."""
    model = CoPoNeRF(ModelConfig(**CFG_KW, fused_argmax=fused), image_size=IMG).eval()
    model.load_state_dict(weights, strict=True)
    seen = {}
    hook = model.feature_cost_aggregation.register_forward_hook(lambda mod, args, out: seen.update(c=out[2]))
    with torch.no_grad():
        state = model.encode(tb)
    hook.remove()
    return state, seen["c"]


@pytest.fixture(scope="module")
def encodes():
    batch_np, _ = make_batch(batch_size=1, image_size=IMG, n_rays=16, seed=0)
    batch = jax.tree.map(jnp.asarray, batch_np)
    jm = JaxCoPoNeRF(JaxModelConfig(**CFG_KW, fused_argmax=True))
    variables = fast_init(jm, batch, val=False, train=False)
    state, inter = jm.apply(
        variables, batch, train=False, method="encode", mutable=["intermediates"],
        capture_intermediates=lambda mdl, method: mdl.name == "feature_cost_aggregation" and method == "__call__",
    )
    jax_c = inter["intermediates"]["feature_cost_aggregation"]["__call__"][0][2]
    weights = convert(jax.tree.map(np.asarray, variables))
    tb = batch_to_torch(batch_np, "cpu")
    return (state, jax_c), _port_encode(True, weights, tb), _port_encode(False, weights, tb)


def test_fused_encode_matches_jax(encodes):
    (rs, rc), (gs, gc), _ = encodes
    assert len(gs.flows) == len(rs.flows) == 4       # flow, flow_flip, mapping_fwd, mapping_bwd
    for a, b in zip(gs.flows, rs.flows):
        assert a.shape == b.shape
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    np.testing.assert_allclose(_np(gc), _np(rc), **TOL)
    np.testing.assert_allclose(_np(gs.rel_pose), _np(rs.rel_pose), **TOL)
    np.testing.assert_array_equal(_np(gs.mask_bwd), _np(rs.mask_bwd))


def test_fused_encode_matches_unfused(encodes):
    _, (fs, fc), (us, uc) = encodes
    torch.testing.assert_close(fc, uc, atol=0, rtol=0)
    torch.testing.assert_close(fs.rel_pose, us.rel_pose, atol=0, rtol=0)
    for a, b in zip(fs.flows[:2], us.flows[:2]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def step():
    return run_both(dict(CFG_KW, fused_argmax=True), dict(pose=True, cycle=True, ssim=True), seed=0)


def test_fused_step_losses_and_grad_norm_match_jax(step):
    _, _, jm, tstate, tm = step
    check_exact_losses_and_grad_norm(jm, tm, tstate)


def test_fused_step_gradients_match_jax_leaf_by_leaf(step):
    _, jax_after, _, tstate, _ = step
    check_exact_gradients(jax_after, tstate)


def test_fused_step_updates_params_and_bn_stats_like_jax(step):
    before, jax_after, _, tstate, _ = step
    check_exact_updates_and_bn_stats(before, jax_after, tstate)
