"""A model built with a fusion: the fast inference render with K7
(``"attn_embed"``: both attention rounds' logits) or K6 (``"render_core"``:
everything between sampling and the decoder), held to the JAX model's
UNFUSED fast render at the fast slice's bounds (mean-relative rgb < 2e-2,
mean at_wt error < 2e-2; ``tests/test_torch_slice_fast.py``), val and
non-val, in the tiny config of that file as one stage of 8 samples (both
fusions).  Its cf(6, 4) form (``attn_embed`` only: K6 serves one stage)
is held to JAX in ``tests/test_torch_slice_fast.py``, which computes the
JAX references of that configuration anyway.  Each fused model holds the
unfused model's weights (``CoPoNeRF.with_fusion``).  As there, the val render is
held to JAX on JAX's own SceneState and the non-val render runs on the
port's own encode.  On the CPU the kernels' plain versions run.
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
              compute_dtype="bfloat16", coarse_samples=0, fine_samples=0)
FUSIONS = ("attn_embed", "render_core")
SE = 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tt(x, bf16=False):
    t = torch.from_numpy(np.array(_np(x)))
    return t.bfloat16() if bf16 else t


def _to_port_state(s) -> SceneState:
    return SceneState(
        z=tuple(_tt(z, z.dtype == jnp.bfloat16) for z in s.z), rel_pose=_tt(s.rel_pose),
        flows=tuple(_tt(f) for f in s.flows), mask_bwd=_tt(s.mask_bwd), kps_flow_bwd=_tt(s.kps_flow_bwd),
        z0_bf16=None if s.z0_bf16 is None else _tt(s.z0_bf16, True),
    )


def _mean_rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).mean() / (np.abs(b).mean() + 1e-6)


@pytest.fixture(scope="module")
def rendered():
    """JAX's unfused fast renders (val, non-val) and the port's fused ones."""
    kw = CFG_KW
    batch_np, _ = make_batch(batch_size=1, image_size=IMG, n_rays=N_RAYS, seed=0)
    batch = jax.tree.map(jnp.asarray, batch_np)
    jm = JaxCoPoNeRF(JaxModelConfig(**kw))
    variables = fast_init(jm, batch, val=False, train=False)
    jstate = jm.apply(variables, batch, train=False, method="encode")
    ref = {v: jm.apply(variables, batch, jstate, val=v, method="render") for v in (False, True)}
    port = CoPoNeRF(ModelConfig(**kw), image_size=IMG).eval()
    port.load_state_dict(convert(jax.tree.map(np.asarray, variables)), strict=True)
    tb = batch_to_torch(batch_np, "cpu")
    with torch.no_grad():
        own, theirs = port.encode(tb), _to_port_state(jstate)
        fused = {f: port.with_fusion(f) for f in FUSIONS}
        got = {(f, v): fused[f].render(tb, theirs if v else own, val=v) for f in FUSIONS for v in (False, True)}
    return ref, got


def test_fused_render_matches_jax_unfused(rendered):
    ref, got = rendered
    for (fusion, val), out in got.items():
        jout = ref[val]
        assert out["rgb"].shape == (1, 1, N_RAYS, 3), fusion
        assert out["at_wt"].shape == (2, N_RAYS, SE), fusion
        assert torch.isfinite(out["rgb"]).all() and torch.isfinite(out["at_wt"]).all(), fusion
        assert _mean_rel(out["rgb"], jout["rgb"]) < 2e-2, (fusion, val)
        assert np.abs(_np(out["at_wt"]) - _np(jout["at_wt"])).mean() < 2e-2, (fusion, val)


def test_fused_render_weights_sum_to_one(rendered):
    _, got = rendered
    for (fusion, val), out in got.items():
        w = _np(out["at_wt"]).reshape(1, 2, N_RAYS, SE)
        np.testing.assert_allclose(w.sum(axis=(1, 3)), 1.0, atol=1e-4, err_msg=f"{fusion} val={val}")
        assert out["pixel_val"].shape[-2] == SE
        for k in ("depth_ray", "T_to_C1_pts", "matchability_cycle_mask"):
            assert torch.isfinite(out[k]).all(), (fusion, k)
