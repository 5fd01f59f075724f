"""The whole inference slice in the fast config (bf16, sample-major tokens,
coarse-to-fine cf(6, 4), K1/K2/K3 through their plain versions on the CPU),
held to the JAX model's fast config at bf16 level: mean-relative rgb error
< 2e-2 and mean at_wt error < 2e-2, as ``tests/test_model.py`` holds the
JAX fast path to its exact one.  Not max-abs: bf16 logits can flip the
argmax that picks a ray's fine interval.

At random weights the pose head amplifies bf16 rounding noise: the JAX
package's own fast and exact encodes give relative poses ~0.15 apart.  So
the val-mode render, whose second hypothesis is posed by that estimate, is
held to JAX on JAX's own SceneState (converted), and the port's end-to-end
encode+render is held to JAX in non-val mode, which does not read the pose.
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
from coponerf_tpu_torch.models import CoPoNeRF, SceneState, batch_to_torch
from coponerf_tpu_torch.utils.convert import convert

torch.set_num_threads(2)

IMG = 32
N_RAYS = 24
CFG_KW = dict(mask_upsample=IMG, npoints=8, ufc_layer_nums=(1, 1, 1), fast_sampling=True,
              compute_dtype="bfloat16", coarse_samples=6, fine_samples=4)
CFG = ModelConfig(**CFG_KW)
SE = 6 + 4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tt(x, like_bf16=False):
    t = torch.from_numpy(np.array(_np(x)))
    return t.bfloat16() if like_bf16 else t


def _to_port_state(s) -> SceneState:
    return SceneState(
        z=tuple(_tt(z, z.dtype == jnp.bfloat16) for z in s.z), rel_pose=_tt(s.rel_pose),
        flows=tuple(_tt(f) for f in s.flows), mask_bwd=_tt(s.mask_bwd),
        kps_flow_bwd=_tt(s.kps_flow_bwd),
        z0_bf16=None if s.z0_bf16 is None else _tt(s.z0_bf16, True),
    )


def _mean_rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).mean() / (np.abs(b).mean() + 1e-6)


@pytest.fixture(scope="module")
def fast_pair():
    batch_np, _ = make_batch(batch_size=1, image_size=IMG, n_rays=N_RAYS, seed=0)
    batch = jax.tree.map(jnp.asarray, batch_np)
    jm = JaxCoPoNeRF(JaxModelConfig(**CFG_KW))
    variables = fast_init(jm, batch, val=False, train=False)
    jstate = jm.apply(variables, batch, train=False, method="encode")
    ref = {v: jm.apply(variables, batch, jstate, val=v, method="render") for v in (False, True)}
    port = CoPoNeRF(CFG, image_size=IMG).eval()
    port.load_state_dict(convert(jax.tree.map(np.asarray, variables)), strict=True)
    tb = batch_to_torch(batch_np, "cpu")
    with torch.no_grad():
        state = port.encode(tb)
        got = {
            "own_nonval": port.render(tb, state, val=False),
            "own_val": port.render(tb, state, val=True),
            "jaxstate_val": port.render(tb, _to_port_state(jstate), val=True),
        }
    return jstate, ref, state, got


def test_fast_encode_matches_jax_at_bf16_level(fast_pair):
    jstate, _, state, _ = fast_pair
    assert all(z.dtype == torch.bfloat16 for z in state.z)
    assert state.rel_pose.dtype == torch.float32
    for a, b in zip(state.z, jstate.z):
        assert _mean_rel(a, b) < 2e-2
    for a, b in zip(state.flows, jstate.flows):
        assert _mean_rel(a, b) < 2e-2
    assert np.abs(_np(state.mask_bwd) - _np(jstate.mask_bwd)).mean() < 2e-2
    R = state.rel_pose[:, :3, :3]
    torch.testing.assert_close(R @ R.transpose(1, 2), torch.eye(3)[None], atol=1e-5, rtol=0)


@pytest.mark.parametrize("case, val", [("jaxstate_val", True), ("own_nonval", False)])
def test_fast_render_matches_jax(fast_pair, case, val):
    _, ref, _, got = fast_pair
    out, jout = got[case], ref[val]
    assert out["rgb"].shape == (1, 1, N_RAYS, 3)
    assert out["at_wt"].shape == (2, N_RAYS, SE)
    assert torch.isfinite(out["rgb"]).all()
    assert _mean_rel(out["rgb"], jout["rgb"]) < 2e-2
    assert np.abs(_np(out["at_wt"]) - _np(jout["at_wt"])).mean() < 2e-2


def test_fast_val_render_contracts(fast_pair):
    _, _, _, got = fast_pair
    out = got["own_val"]
    assert out["pixel_val"].shape[-2] == SE
    w = _np(out["at_wt"]).reshape(1, 2, N_RAYS, SE)
    np.testing.assert_allclose(w.sum(axis=(1, 3)), 1.0, atol=1e-4)
    for k in ("rgb", "depth_ray", "T_to_C1_pts"):
        assert torch.isfinite(out[k]).all(), k
