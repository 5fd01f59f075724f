"""The whole inference slice in the exact config (f32, ray-major tokens, one
uniform stage): the port's encode and render, with weights converted from
the JAX package's ``fast_init``, held to the JAX model at atol/rtol 1e-4.

In val mode the correspondence-transfer outputs ``T_to_C*_pts`` (pixels
(x, y) = (X/Z, Y/Z) of a transferred point) have a few rays whose target
depth Z is near 0, where the affine pixel amplifies depth_ray's own f32
round-off (which matches JAX at ~1e-6) past any fixed bound.  There they
are compared as the projective points they are: the unit vectors of
(x, y, 1), at the same 1e-4.  Non-val mode compares the pixels themselves.

The JAX reference is computed once per module (eager JAX on the CPU takes
about a minute at this size).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from coponerf_tpu.config import ModelConfig
from coponerf_tpu.data.synthetic import make_batch
from coponerf_tpu.models import CoPoNeRF as JaxCoPoNeRF
from coponerf_tpu.utils.fast_init import fast_init
from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
from coponerf_tpu_torch.utils.convert import convert

torch.set_num_threads(2)

IMG = 32
N_RAYS = 24
CFG = ModelConfig(mask_upsample=IMG, npoints=8, ufc_layer_nums=(1, 1, 1))
TOL = dict(atol=1e-4, rtol=1e-4)
RENDER_KEYS = ("rgb", "at_wt", "depth_ray", "T_to_C1_pts", "T_to_C2_pts",
               "matchability_cycle_mask", "mask_c2")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _projective(xy):
    h = np.concatenate([xy, np.ones_like(xy[..., :1])], axis=-1)
    return h / np.linalg.norm(h, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def slice_pair():
    batch_np, _ = make_batch(batch_size=1, image_size=IMG, n_rays=N_RAYS, seed=0)
    batch = jax.tree.map(jnp.asarray, batch_np)
    jm = JaxCoPoNeRF(CFG)
    variables = fast_init(jm, batch, val=False, train=False)
    state = jm.apply(variables, batch, train=False, method="encode")
    ref = {"state": state}
    for val in (False, True):
        ref[val] = jm.apply(variables, batch, state, val=val, method="render")
    port = CoPoNeRF(CFG, image_size=IMG).eval()
    port.load_state_dict(convert(jax.tree.map(np.asarray, variables)), strict=True)
    tb = batch_to_torch(batch_np, "cpu")
    st = port.encode(tb)
    got = {"state": st}
    for val in (False, True):
        got[val] = port.render(tb, st, val=val)
    return ref, got, port, tb


def test_encode_matches_jax(slice_pair):
    ref, got, _, _ = slice_pair
    rs, gs = ref["state"], got["state"]
    np.testing.assert_allclose(_np(gs.rel_pose), _np(rs.rel_pose), **TOL)
    for a, b in zip(gs.flows, rs.flows):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    for a, b in zip(gs.z, rs.z):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    np.testing.assert_array_equal(_np(gs.mask_bwd), _np(rs.mask_bwd))
    np.testing.assert_allclose(_np(gs.kps_flow_bwd), _np(rs.kps_flow_bwd), **TOL)


@pytest.mark.parametrize("val", [False, True])
@pytest.mark.parametrize("key", RENDER_KEYS)
def test_render_matches_jax(slice_pair, val, key):
    ref, got, _, _ = slice_pair
    a, b = _np(got[val][key]), _np(ref[val][key])
    assert a.shape == b.shape
    if val and key.startswith("T_to_C"):
        a, b = _projective(a), _projective(b)
    np.testing.assert_allclose(a, b, **TOL)


def test_valid_ray_mask_matches_render(slice_pair):
    ref, got, port, tb = slice_pair
    for val in (False, True):
        mask = port.valid_ray_mask(tb, got["state"], val=val)
        np.testing.assert_array_equal(mask.numpy(), _np(got[val]["valid_mask"])[..., 0] > 0)


def test_train_mode_is_not_ported(slice_pair):
    _, got, port, tb = slice_pair
    with pytest.raises(NotImplementedError):
        port.encode(tb, train=True)
    with pytest.raises(NotImplementedError):
        port.render(tb, got["state"], train=True)
