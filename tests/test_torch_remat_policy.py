"""``remat_policy`` in the port's UFC, on the CPU.

A narrow UFC (4 heads, width 32, one layer a stage, grids 4/8/16, f32)
from JAX's flax variables, the loss of ``tests/test_ops.py``'s remat test
(every feature map, the fused correlation and the forward flow) under no
remat, ``remat`` with the ``"full"`` policy and with ``"dots"``:
  - the loss and every gradient agree at 1e-6 relative (the recompute is
    the forward's own operations on the CPU, so bit for bit is expected);
  - a dispatch-mode counter in the backward sees as many matrix products
    (``mm``, ``bmm``, ``addmm``, ``baddbmm``) under ``"dots"`` as without
    remat (none recomputed: their outputs were kept) and more under
    ``"full"`` (the recompute runs the layer's products again);
  - the gradients under ``"dots"`` against JAX's UFC under
    ``remat_policy="dots"`` (its ``dots_saveable``) at 1e-4, the module
    tests' bound.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from coponerf_tpu.models.ufc import UFC as JaxUFC
from coponerf_tpu_torch.config import ModelConfig
from coponerf_tpu_torch.models.ufc import UFC
from coponerf_tpu_torch.utils.convert import convert, flax_path
from torch_step_helpers import to_flax_layout

torch.set_num_threads(2)

DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
        torch.ops.aten.baddbmm.default}
KW = dict(nhead=4, feat_dim=(32, 32, 32), layer_nums=(1, 1, 1))


class CountDots(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in DOTS
        return func(*args, **(kwargs or {}))


def _feats():
    rng = np.random.RandomState(0)
    return [rng.randn(2, 4 * 2 ** s, 4 * 2 ** s, 16).astype(np.float32) for s in range(3)]


def _loss(feat_list, flows, c):
    return sum((f * f).mean() for f in feat_list) + (c * c).mean() + (flows[0] ** 2).mean()


@pytest.fixture(scope="module")
def variables():
    feats = [jnp.asarray(f) for f in _feats()]
    return jax.jit(JaxUFC(**KW, remat=False).init)(jax.random.PRNGKey(0), feats)


def _port_run(variables, remat, policy):
    """(loss, {name: gradient}, matrix products in the backward)."""
    m = UFC((4, 8, 16), in_dims=(16, 16, 16), **KW, remat=remat, remat_policy=policy)
    m.load_state_dict(convert(jax.tree.map(np.asarray, variables)), strict=True)
    loss = _loss(*m([torch.from_numpy(f) for f in _feats()]))
    counter = CountDots()
    with counter:
        loss.backward()
    return loss.item(), {k: p.grad for k, p in m.named_parameters() if p.grad is not None}, counter.n


@pytest.fixture(scope="module")
def runs(variables):
    return {key: _port_run(variables, remat, policy)
            for key, (remat, policy) in {"off": (False, "full"), "full": (True, "full"),
                                         "dots": (True, "dots")}.items()}


@pytest.mark.parametrize("key", ["full", "dots"])
def test_remat_gradients_equal_no_remat(runs, key):
    l0, g0, _ = runs["off"]
    l1, g1, _ = runs[key]
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    assert g1.keys() == g0.keys() and len(g0) > 50
    for k in g0:
        err = float((g1[k] - g0[k]).abs().max()) / (float(g0[k].abs().max()) + 1e-12)
        assert err <= 1e-6, (key, k, err)


def test_dots_policy_recomputes_no_matrix_product(runs):
    off, full, dots = runs["off"][2], runs["full"][2], runs["dots"][2]
    assert off > 0
    assert dots == off, (dots, off)
    assert full > off, (full, off)


def test_dots_gradients_match_jax_dots(variables, runs):
    feats = [jnp.asarray(f) for f in _feats()]
    jm = JaxUFC(**KW, remat=True, remat_policy="dots")
    grads = jax.jit(jax.grad(lambda v: _loss(*jm.apply(v, feats))))(variables)
    _, got, _ = runs["dots"]
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(grads)}
    compared = 0
    for k, g in got.items():
        path, _ = flax_path(k, tuple(g.shape))
        ref = flat["/".join(path)]
        mine = to_flax_layout(k, g.numpy())
        np.testing.assert_allclose(mine / (np.abs(ref).max() + 1e-12), ref / (np.abs(ref).max() + 1e-12),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
        compared += 1
    assert compared == len(got)


def test_remat_policy_is_checked():
    with pytest.raises(ValueError, match="remat_policy"):
        ModelConfig(remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        UFC((8, 16, 32), remat=True, remat_policy="everything")
