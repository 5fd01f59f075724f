"""``conv4d_impl="3d"`` in the port, held to the JAX package on the CPU.

The port's ``Conv4d(impl="3d")`` (one ``conv3d`` a branch on the
flattened volume) against JAX's ``Conv4d(impl="3d")`` from the same flax
variables, and against the port's own ``"2d"`` fold with the same
weights, forward and gradients, f32, 1e-5: at each kernel, stride and
padding the UFC uses (k3 s1 p1 in the layers' volumes, k3 s2 p1 and k5 s4
p2 in the feature-to-correlation encoders), with 1-8 input channels.  A
narrow ``encode()`` with ``conv4d_impl="3d"`` against JAX's at the exact
slice's 1e-4 (``tests/test_torch_slice_exact.py``); the JAX encode runs
once per module.
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
from coponerf_tpu.utils.fast_init import fast_init
from coponerf_tpu_torch.config import ModelConfig
from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
from coponerf_tpu_torch.models.conv4d import Conv4d
from coponerf_tpu_torch.utils.convert import convert

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
IMG = 32
CFG_KW = dict(mask_upsample=IMG, npoints=8, ufc_layer_nums=(1, 1, 1), conv4d_impl="3d")

# (kernel, stride, pad, in channels, out channels, volume side): the UFC's
# three shapes of Conv4d
CASES = [(3, 1, 1, 8, 8, 8), (3, 1, 1, 1, 4, 8), (3, 2, 1, 1, 8, 16), (5, 4, 2, 1, 8, 16)]
IDS = ["k3s1p1_L8", "k3s1p1_L1", "k3s2p1", "k5s4p2"]


def _volume(L, side, seed):
    return np.random.RandomState(seed).randn(2, L, side * side, side * side).astype(np.float32)


def _port(impl, L, O, k, s, p, variables):
    m = Conv4d(L, O, (k,) * 4, (s,) * 4, (p,) * 4, impl=impl)
    m.load_state_dict(convert(jax.tree.map(np.asarray, variables)), strict=True)
    return m


@pytest.mark.parametrize("k, s, p, L, O, side", CASES, ids=IDS)
def test_conv4d_3d_matches_jax_3d(k, s, p, L, O, side):
    x = _volume(L, side, seed=k + s + L)
    jm = JaxConv4d(O, (k,) * 4, (s,) * 4, (p,) * 4, impl="3d")
    variables = jm.init(jax.random.PRNGKey(k), jnp.asarray(x), (side, side), (side, side))
    ref, rq, rs = jm.apply(variables, jnp.asarray(x), (side, side), (side, side))
    got, gq, gs = _port("3d", L, O, k, s, p, variables)(torch.from_numpy(x), (side, side), (side, side))
    assert (tuple(gq), tuple(gs)) == (tuple(rq), tuple(rs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("k, s, p, L, O, side", CASES, ids=IDS)
def test_conv4d_3d_matches_2d_forward_and_gradients(k, s, p, L, O, side):
    """The same weights through both formulations: outputs, new grid sizes,
    and the gradients of the input and of every weight and bias."""
    x = _volume(L, side, seed=10 + k + s + L)
    jm = JaxConv4d(O, (k,) * 4, (s,) * 4, (p,) * 4)
    variables = jm.init(jax.random.PRNGKey(k + 1), jnp.asarray(x), (side, side), (side, side))
    res = {}
    for impl in ("2d", "3d"):
        m = _port(impl, L, O, k, s, p, variables)
        xt = torch.from_numpy(x).requires_grad_(True)
        out, q, sh = m(xt, (side, side), (side, side))
        (out * torch.cos(out)).sum().backward()
        res[impl] = (out.detach(), (tuple(q), tuple(sh)), xt.grad, {n: t.grad for n, t in m.named_parameters()})
    (o2, d2, gx2, gp2), (o3, d3, gx3, gp3) = res["2d"], res["3d"]
    assert d2 == d3
    np.testing.assert_allclose(o3.numpy(), o2.numpy(), **TOL)
    np.testing.assert_allclose(gx3.numpy(), gx2.numpy(), **TOL)
    assert gp2.keys() == gp3.keys() == {"query_conv.weight", "query_conv.bias", "supp_conv.weight",
                                        "supp_conv.bias"}
    for n in gp2:
        scale = float(gp2[n].abs().max())
        np.testing.assert_allclose(gp3[n].numpy() / scale, gp2[n].numpy() / scale, **TOL, err_msg=n)


def test_conv4d_3d_keeps_the_bf16_dtype_rules():
    """In bf16 the weights are cast to the input's dtype as in the 2d fold:
    the output is bf16 and within bf16 round-off of the 2d output."""
    x = torch.from_numpy(_volume(8, 8, seed=3))
    torch.manual_seed(0)
    m2 = Conv4d(8, 8, (3,) * 4, (1,) * 4, (1,) * 4, dtype=torch.bfloat16)
    m3 = Conv4d(8, 8, (3,) * 4, (1,) * 4, (1,) * 4, dtype=torch.bfloat16, impl="3d")
    m3.load_state_dict(m2.state_dict())
    with torch.no_grad():
        o2, _, _ = m2(x, (8, 8), (8, 8))
        o3, _, _ = m3(x, (8, 8), (8, 8))
    assert o2.dtype == o3.dtype == torch.bfloat16
    err = float((o3.float() - o2.float()).abs().max() / o2.float().abs().max())
    assert err < 2e-2, err


def test_conv4d_impl_is_checked():
    with pytest.raises(ValueError, match="impl"):
        Conv4d(1, 1, (3,) * 4, (1,) * 4, (1,) * 4, impl="4d")
    with pytest.raises(ValueError, match="conv4d_impl"):
        ModelConfig(conv4d_impl="4d")


@pytest.fixture(scope="module")
def encode_pair():
    batch_np, _ = make_batch(batch_size=1, image_size=IMG, n_rays=8, seed=0)
    batch = jax.tree.map(jnp.asarray, batch_np)
    jm = JaxCoPoNeRF(JaxModelConfig(**CFG_KW))
    variables = fast_init(jm, batch, val=False, train=False)
    ref = jm.apply(variables, batch, train=False, method="encode")
    port = CoPoNeRF(ModelConfig(**CFG_KW), image_size=IMG).eval()
    port.load_state_dict(convert(jax.tree.map(np.asarray, variables)), strict=True)
    with torch.no_grad():
        got = port.encode(batch_to_torch(batch_np, "cpu"))
    return ref, got


def test_encode_3d_matches_jax_3d(encode_pair):
    ref, got = encode_pair
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.rel_pose.numpy(), np.asarray(ref.rel_pose), **tol)
    for a, b in zip(got.flows, ref.flows):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    for a, b in zip(got.z, ref.z):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)), **tol)
    np.testing.assert_array_equal(got.mask_bwd.numpy(), np.asarray(ref.mask_bwd))
    np.testing.assert_allclose(got.kps_flow_bwd.numpy(), np.asarray(ref.kps_flow_bwd), **tol)
