"""The port's parameter converter, seeded init and modules, held to the JAX
package on the CPU: each JAX module is initialised by flax, its variables
go through ``utils/convert.py`` into the port's module (strict load), and
both run the same numpy input.  f32 atol 1e-4.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from coponerf_tpu.config import ModelConfig as JaxModelConfig
from coponerf_tpu.data.synthetic import make_batch
from coponerf_tpu.models import CoPoNeRF as JaxCoPoNeRF
from coponerf_tpu.models.conv4d import Conv4d as JaxConv4d
from coponerf_tpu.models.cross_block import CrossBlock as JaxCrossBlock
from coponerf_tpu.models.lightfield import ResnetFC as JaxResnetFC
from coponerf_tpu.models.resnet import ResNet34Encoder as JaxResNet
from coponerf_tpu.models.ufc import UFCLayer as JaxUFCLayer
from coponerf_tpu.utils.fast_init import fast_init
from coponerf_tpu_torch.config import ModelConfig
from coponerf_tpu_torch.models import CoPoNeRF
from coponerf_tpu_torch.models.conv4d import Conv4d
from coponerf_tpu_torch.models.cross_block import CrossBlock
from coponerf_tpu_torch.models.lightfield import ResnetFC
from coponerf_tpu_torch.models.resnet import ResNet34Encoder
from coponerf_tpu_torch.models.ufc import UFCLayer
from coponerf_tpu_torch.utils.convert import convert
from coponerf_tpu_torch.utils.init import init_state_dict

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _port(module: torch.nn.Module, variables) -> torch.nn.Module:
    module.load_state_dict(convert(jax.tree.map(np.asarray, variables)), strict=True)
    return module.eval()


def test_convert_round_trip_and_seeded_init():
    """fast_init -> convert -> strict load consumes every leaf, and the
    port's own seeded init reproduces the same tensors without JAX."""
    cfg_kw = dict(mask_upsample=32, npoints=4, ufc_layer_nums=(1, 1, 1))
    batch_np, _ = make_batch(batch_size=1, image_size=32, n_rays=8, seed=0)
    variables = fast_init(JaxCoPoNeRF(JaxModelConfig(**cfg_kw)), jax.tree.map(jnp.asarray, batch_np),
                          val=False, train=False)
    sd = convert(jax.tree.map(np.asarray, variables))
    n_leaves = len(jax.tree.leaves(variables))
    assert len(sd) == n_leaves
    port = CoPoNeRF(ModelConfig(**cfg_kw), image_size=32)
    result = port.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    own = init_state_dict(port, seed=0)
    assert own.keys() == sd.keys()
    for k in sd:
        assert torch.equal(own[k], sd[k]), k
    assert sum(v.numel() for v in sd.values()) == sum(p.numel() for p in port.state_dict().values())


def test_resnet_encoder_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    jm = JaxResNet()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    # non-trivial running statistics, so eval-mode BatchNorm is exercised
    stats = jax.tree.map(lambda a: np.asarray(a), variables["batch_stats"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.rand(*a.shape) + 0.5 if p[-1].key == "var" else rng.randn(*a.shape) * 0.1).astype(np.float32),
        stats,
    )
    variables = {"params": variables["params"], "batch_stats": stats}
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    got = _port(ResNet34Encoder(), variables)(torch.from_numpy(x))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


@pytest.mark.parametrize("k, s, p, L, O", [(3, 1, 1, 4, 6), (5, 4, 2, 1, 4), (3, 2, 1, 2, 3)])
def test_conv4d_matches_jax(k, s, p, L, O):
    rng = np.random.RandomState(1)
    x = rng.randn(2, L, 64, 64).astype(np.float32)
    args = ((k,) * 4, (s,) * 4, (p,) * 4)
    jm = JaxConv4d(O, *args)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), (8, 8), (8, 8))
    ref, rq, rs = jm.apply(variables, jnp.asarray(x), (8, 8), (8, 8))
    got, gq, gs = _port(Conv4d(L, O, *args), variables)(torch.from_numpy(x), (8, 8), (8, 8))
    assert (tuple(gq), tuple(gs)) == (tuple(rq), tuple(rs))
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


def test_ufc_layer_matches_jax():
    rng = np.random.RandomState(2)
    kw = dict(feat_dim=32, corr_size=4, d_model=32, nhead=4, feat_size=(8, 8),
              feat_to_corr_kernel=3, feat_to_corr_stride=2, feat_to_corr_pad=1)
    corr = rng.randn(1, 4, 16, 16).astype(np.float32) * 0.3
    feat2 = rng.randn(2, 64, 32).astype(np.float32)
    jm = JaxUFCLayer(**kw)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(corr), jnp.asarray(feat2))
    ref = jm.apply(variables, jnp.asarray(corr), jnp.asarray(feat2))
    got = _port(UFCLayer(**kw), variables)(torch.from_numpy(corr), torch.from_numpy(feat2))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_cross_block_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, 256).astype(np.float32)
    corr = rng.randn(1, 1, 16, 16).astype(np.float32) * 0.5
    intr = tuple(np.full((1, 1), v, np.float32) for v in (0.9, 0.9, 0.5, 0.5))
    jm = JaxCrossBlock()
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(corr), intr)
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(corr), intr)
    got = _port(CrossBlock(), variables)(torch.from_numpy(x), torch.from_numpy(corr),
                                         tuple(torch.from_numpy(v) for v in intr))
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


def test_resnet_fc_matches_jax():
    rng = np.random.RandomState(4)
    zx = rng.randn(2, 10, 64 + 18).astype(np.float32)
    jm = JaxResnetFC(d_in=18, d_latent=64, d_hidden=32)
    variables = jm.init(jax.random.PRNGKey(4), jnp.asarray(zx))
    # the decoder's zero-initialised fc_1 layers would hide the residual path
    params = jax.tree.map(lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32) * 0.1,
                          variables["params"])
    ref = jm.apply({"params": params}, jnp.asarray(zx))
    got = _port(ResnetFC(d_in=18, d_latent=64, d_hidden=32), {"params": params})(torch.from_numpy(zx))
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


def _refine_every_layer(monkeypatch):
    """Make every UFC layer refine its volume a second time, as the port
    did before the last layer skipped it."""
    forward = UFCLayer.forward
    monkeypatch.setattr(UFCLayer, "forward", lambda self, corr, feat2, refine_last_corr=True:
                        forward(self, corr, feat2, True))


def test_ufc_layer_refine_flag_changes_only_the_volume():
    """``refine_last_corr=False`` skips ``feat_to_corr2`` and
    ``mlp_refine_corr2``: the features come out bit for bit, the volume
    without the second refinement, as JAX's layer with the flag off."""
    rng = np.random.RandomState(5)
    kw = dict(feat_dim=32, corr_size=4, d_model=32, nhead=4, feat_size=(8, 8),
              feat_to_corr_kernel=3, feat_to_corr_stride=2, feat_to_corr_pad=1)
    corr = rng.randn(1, 4, 16, 16).astype(np.float32) * 0.3
    feat2 = rng.randn(2, 64, 32).astype(np.float32)
    jm = JaxUFCLayer(**kw)
    variables = jm.init(jax.random.PRNGKey(5), jnp.asarray(corr), jnp.asarray(feat2))
    layer = _port(UFCLayer(**kw), variables)
    with torch.no_grad():
        on = layer(torch.from_numpy(corr), torch.from_numpy(feat2), True)
        off = layer(torch.from_numpy(corr), torch.from_numpy(feat2), False)
    assert torch.equal(on[1], off[1])
    assert not torch.equal(on[0], off[0])
    ref = jm.apply(variables, jnp.asarray(corr), jnp.asarray(feat2), False)
    for a, b in zip(off, ref):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_last_layer_skips_its_dead_refinement_bit_for_bit(fast, monkeypatch):
    """Skipping the last UFC layer's second refinement changes no number: a
    narrow model's eval ``encode()`` and its train-mode losses and
    gradients are bit for bit those of the model that refines in every
    layer (fast config: bf16 and UFC remat), and the same 18 parameters, the
    last layer's ``feat_to_corr2`` and ``mlp_refine_corr2``, get no
    gradient."""
    from coponerf_tpu_torch.config import LossConfig
    from coponerf_tpu_torch.models import batch_to_torch
    from coponerf_tpu_torch.training.losses import lf_loss
    from coponerf_tpu_torch.utils.init import init_weights

    kw = dict(mask_upsample=32, npoints=4, ufc_layer_nums=(1, 1, 1))
    if fast:
        kw.update(fast_sampling=True, compute_dtype="bfloat16")
    cfg = ModelConfig(**kw)
    weights = init_weights(CoPoNeRF(cfg, image_size=32), seed=4).state_dict()
    batch_np, _ = make_batch(batch_size=2, image_size=32, n_rays=16, seed=4)
    runs = {}
    for every_layer in (False, True):
        with monkeypatch.context() as m:
            if every_layer:
                _refine_every_layer(m)
            model = CoPoNeRF(cfg, image_size=32)
            model.load_state_dict(weights)
            tb = batch_to_torch(batch_np, "cpu")
            with torch.no_grad():
                state = model.eval().encode(tb)
            model.train()
            out = model(tb, val=False, train=True)
            losses, _ = lf_loss(LossConfig(pose=True, cycle=True, ssim=True), tb, out, tb["query"])
            sum(losses.values()).backward()
            runs[every_layer] = (state, losses, {k: p.grad for k, p in model.named_parameters()})
    (s0, l0, g0), (s1, l1, g1) = runs[False], runs[True]
    for a, b in zip((s0.rel_pose, *s0.flows, *s0.z), (s1.rel_pose, *s1.flows, *s1.z)):
        assert torch.equal(a, b)
    assert l0.keys() == l1.keys() and all(torch.equal(l0[k], l1[k]) for k in l0)
    gradless = sorted(k for k, g in g0.items() if g is None)
    assert gradless == sorted(k for k, g in g1.items() if g is None)
    assert len(gradless) == 18
    assert all(k.startswith(("feature_cost_aggregation.layers_2_0.feat_to_corr2.",
                             "feature_cost_aggregation.layers_2_0.mlp_refine_corr2.")) for k in gradless)
    for k, g in g0.items():
        if g is not None:
            assert torch.equal(g, g1[k]), k
