"""The port's import of reference ``.pth`` checkpoints
(``coponerf_tpu_torch/utils/torch_import.py``) against the JAX package's.

A test-side inverse of the JAX package's key map turns JAX-initialised
narrow variables into a state dict keyed as the reference's ``CoPoNeRF``
(torchvision ResNet-34 names, Conv1d heads, Sequential indices), with every
kind of key the import skips, saved with ``torch.save`` under ``"model"``.
The JAX package's ``convert_state_dict`` gives the variables back bit for
bit, which proves the inverse; the port's ``import_reference`` must then
equal ``convert(variables)`` bit for bit, and an encode + render with the
imported weights must match the JAX model at the exact slice's 1e-4
(``tests/test_torch_slice_exact.py``).  A key outside the maps, a missing
key and a wrong shape raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coponerf_tpu.config import ModelConfig as JaxModelConfig
from coponerf_tpu.data.synthetic import make_batch
from coponerf_tpu.models import CoPoNeRF as JaxCoPoNeRF
from coponerf_tpu.utils.fast_init import fast_init
from coponerf_tpu.utils.torch_import import convert_state_dict as j_convert_state_dict
from coponerf_tpu.utils.torch_import import load_torch_checkpoint as j_load_torch_checkpoint
from coponerf_tpu_torch.config import ModelConfig
from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
from coponerf_tpu_torch.training.checkpoint import load_weights
from coponerf_tpu_torch.utils import torch_import
from coponerf_tpu_torch.utils.convert import convert
from torch_reference_keys import reference_state_dict

torch.set_num_threads(2)

IMG = 32
CFG_KW = dict(npoints=4, ufc_layer_nums=(1, 1, 1), mask_upsample=IMG)
TOL = dict(atol=1e-4, rtol=1e-4)

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    batch_np, _ = make_batch(batch_size=1, image_size=IMG, n_rays=16, seed=0)
    batch = jax.tree.map(jnp.asarray, batch_np)
    jm = JaxCoPoNeRF(JaxModelConfig(**CFG_KW))
    variables = jax.tree.map(np.asarray, fast_init(jm, batch, val=False, train=False))
    path = str(tmp_path_factory.mktemp("pth") / "reference.pth")
    torch.save({"model": reference_state_dict(variables), "epoch": 3}, path)
    return variables, path, jm, batch_np


def _assert_tree_equal(a, b, where=""):
    assert isinstance(b, dict) == isinstance(a, dict), where
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (where, sorted(set(a) ^ set(b))[:5])
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{where}/{k}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)


def test_inverse_round_trips_through_jax(setup):
    """The JAX package's own import gives the variables back bit for bit."""
    variables, path, _, _ = setup
    params, batch_stats = j_convert_state_dict(j_load_torch_checkpoint(path))
    _assert_tree_equal(params, variables["params"], "params")
    _assert_tree_equal(batch_stats, variables["batch_stats"], "batch_stats")


def test_port_import_equals_convert(setup):
    """``import_reference`` = ``convert(variables)`` bit for bit, and the
    port's tree step = the JAX package's."""
    variables, path, _, _ = setup
    sd = torch_import.import_reference(path, ModelConfig(**CFG_KW), IMG)
    want = convert(variables)
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    params, batch_stats = torch_import.convert_state_dict(torch_import.load_torch_checkpoint(path))
    _assert_tree_equal(params, variables["params"], "params")
    _assert_tree_equal(batch_stats, variables["batch_stats"], "batch_stats")


def test_imported_weights_render_as_jax(setup):
    """A narrow encode + val render with the imported weights (through the
    checkpoint loader, as the entries load a .pth) against JAX, 1e-4."""
    variables, path, jm, batch_np = setup
    batch = jax.tree.map(jnp.asarray, batch_np)
    jv = jax.tree.map(jnp.asarray, variables)
    jstate = jax.jit(lambda v, b: jm.apply(v, b, train=False, method="encode"))(jv, batch)
    ref = jax.jit(lambda v, b, s: jm.apply(v, b, s, val=True, method="render"))(jv, batch, jstate)
    port = load_weights(CoPoNeRF(ModelConfig(**CFG_KW), image_size=IMG).eval(), path, IMG)
    tb = batch_to_torch(batch_np, "cpu")
    with torch.no_grad():
        st = port.encode(tb)
        got = port.render(tb, st, val=True)
    np.testing.assert_allclose(st.rel_pose.numpy(), np.asarray(jstate.rel_pose), **TOL)
    for k in ("rgb", "depth_ray", "at_wt"):
        np.testing.assert_allclose(got[k].float().numpy(), np.asarray(ref[k], np.float32), err_msg=k, **TOL)


def test_unmapped_missing_and_misshapen_keys_raise(setup, monkeypatch):
    """The key checks on state dicts handed over in memory (the file
    reading is the other tests')."""
    variables, _, _, _ = setup
    cfg = ModelConfig(**CFG_KW)
    base = reference_state_dict(variables)

    def import_(sd, c=cfg, img=IMG):
        monkeypatch.setattr(torch_import, "load_torch_checkpoint", lambda path: {k: v.numpy() for k, v in sd.items()})
        return torch_import.import_reference("in-memory.pth", c, img)

    for extra in ("mystery_head.conv.weight", "encoder.model.layer1.3.conv1.weight", "pose_regressor.1.weight"):
        with pytest.raises(KeyError, match="unmapped"):
            import_(dict(base, **{extra: torch.zeros(2, 2)}))
    missing = dict(base)
    del missing["phi.lin_out.weight"]
    with pytest.raises(KeyError, match="not covered"):
        import_(missing)
    # a layer the module does not have; a module deeper than the file
    deeper = dict(base, **{"feature_cost_aggregation.layers.0.5.q_proj.weight": torch.zeros(256, 288)})
    with pytest.raises(KeyError, match="outside"):
        import_(deeper)
    with pytest.raises(KeyError, match="not covered"):
        import_(base, ModelConfig(npoints=4, ufc_layer_nums=(2, 1, 1), mask_upsample=IMG))
    with pytest.raises(ValueError, match="shapes"):
        import_(base, img=2 * IMG)
