"""``TrainConfig.flat_optimizer`` in the port (Adam over one vector, as
``optax.flatten``), on the CPU.

  - The state: every parameter is a view into the one vector Adam holds,
    every ``.grad`` a view into the one gradient vector.
  - Two flat steps against two per-leaf steps from the same weights and
    batches, narrow exact config with the pose, cycle and SSIM losses, with
    the clip out of reach: the same parameters, moments and metrics at
    1e-6 relative (bit for bit is expected: the two run the same
    operations).  With the clip at its default 1.0 one step agrees at
    1e-6: the norm is summed in another order, so the clip factor can
    differ in its last bit, which moves Adam's first update of an entry
    near zero by an ulp of its parameter, and random-weight training
    amplifies that through later steps (three clipped steps on the CPU
    differ in half the entries), so a clipped second step is not compared.
  - One flat step against JAX's ``flat_optimizer=True`` trainer on one
    batch at the whole-step bounds of ``tests/torch_step_helpers.py``.
  - A non-finite step is skipped whole (``tests/test_optimizer.py:47``),
    and the next finite one applies.
  - ``.pt`` files cross layouts: a per-leaf file restores into a flat state
    and a flat one into a per-leaf state, each with the same moments, and
    the restored flat state's parameters are still its vector's views.
  - A one-rank gloo mesh step with the flat optimizer (its all-reduce acts
    on the gradient vector in place) against the per-leaf mesh step.
"""

import dataclasses
import os
import tempfile

import pytest
import torch

from coponerf_tpu_torch.config import Config, LossConfig, ModelConfig, TrainConfig
from coponerf_tpu_torch.data.synthetic import make_batch
from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
from coponerf_tpu_torch.parallel import mesh as pmesh
from coponerf_tpu_torch.training import checkpoint as ckpt_lib
from coponerf_tpu_torch.training import optim, trainer
from coponerf_tpu_torch.utils.init import init_weights
from torch_step_helpers import (check_exact_gradients, check_exact_losses_and_grad_norm,
                                check_exact_updates_and_bn_stats, run_both)

torch.set_num_threads(2)

IMG = 32
MODEL = dict(mask_upsample=IMG, npoints=8, ufc_layer_nums=(1, 1, 1))
LOSS = dict(pose=True, cycle=True, ssim=True)


def _cfg(flat, **train):
    return Config(model=ModelConfig(**MODEL), loss=LossConfig(**LOSS),
                  train=TrainConfig(lr=1e-4, steps_per_epoch=100, flat_optimizer=flat, **train))


def _batch(seed):
    return batch_to_torch(make_batch(batch_size=2, image_size=IMG, n_rays=16, seed=seed)[0], "cpu")


@pytest.fixture(scope="module")
def weights():
    return init_weights(CoPoNeRF(ModelConfig(**MODEL), image_size=IMG), seed=0).state_dict()


def _state(cfg, weights):
    model = CoPoNeRF(cfg.model, image_size=IMG)
    model.load_state_dict(weights)
    return trainer.create_train_state(cfg, IMG, "cpu", model=model)


def _rel(a, b):
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)


def _assert_states_agree(flat, leaf, tol):
    fa, la = optim.adam_state(flat), optim.adam_state(leaf)
    for (k, p), q in zip(leaf.model.named_parameters(), flat.model.parameters()):
        assert _rel(q.detach(), p.detach()) <= tol, k
        for m in ("exp_avg", "exp_avg_sq"):
            assert _rel(fa[k][m], la[k][m]) <= tol, (k, m)
        assert int(fa[k]["step"]) == int(la[k]["step"]) == leaf.updates
    for k, v in leaf.model.state_dict().items():
        if "running_" in k:
            assert torch.equal(flat.model.state_dict()[k], v), k


def test_flat_state_parameters_and_gradients_are_views(weights):
    state = _state(_cfg(True), weights)
    flat = state.flat
    assert state.optimizer.param_groups[0]["params"] == [flat.param] and flat.param.grad is flat.grad
    lo, hi = flat.param.data_ptr(), flat.param.data_ptr() + flat.param.numel() * 4
    for (k, p), g in zip(state.model.named_parameters(), flat.grads):
        assert lo <= p.data_ptr() < hi and p.grad is g, k
        assert torch.equal(p.detach(), weights[k]), k
    assert flat.param.numel() == sum(v.numel() for k, v in weights.items() if "running_" not in k)


@pytest.mark.parametrize("clip, n_steps", [(1e9, 2), (1.0, 1)], ids=["unclipped_two_steps", "clipped_one_step"])
def test_flat_steps_match_per_leaf_steps(weights, clip, n_steps):
    states = {flat: _state(_cfg(flat, clip_grad_norm=clip), weights) for flat in (False, True)}
    for s in range(n_steps):
        metrics = {flat: trainer.train_step(st, _batch(s + 1), _cfg(flat, clip_grad_norm=clip))
                   for flat, st in states.items()}
        for k, v in metrics[False].items():
            assert abs(float(metrics[True][k]) - float(v)) <= 1e-6 * abs(float(v)), (s, k)
    assert states[True].updates == states[False].updates == n_steps
    _assert_states_agree(states[True], states[False], 1e-6)


def test_flat_step_matches_jax_flat_optimizer():
    before, jax_after, jm, tstate, tm = run_both(MODEL, LOSS, seed=0, flat_optimizer=True)
    assert tstate.flat is not None
    check_exact_losses_and_grad_norm(jm, tm, tstate)
    check_exact_gradients(jax_after, tstate)
    check_exact_updates_and_bn_stats(before, jax_after, tstate)


def test_flat_optimizer_skips_a_nonfinite_step(weights):
    cfg = _cfg(True)
    state = _state(cfg, weights)
    trainer.train_step(state, _batch(2), cfg)
    params = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    adam = {k: v.clone() for k, v in state.optimizer.state[state.flat.param].items()}
    poisoned = _batch(2)
    poisoned["context"]["rgb"][..., 0] = float("nan")
    metrics = trainer.train_step(state, poisoned, cfg)
    assert not torch.isfinite(metrics["grad_norm"])
    assert (state.step, state.updates, state.notfinite_count, state.total_notfinite) == (2, 1, 1, 1)
    for k, p in state.model.named_parameters():
        assert torch.equal(p.detach(), params[k]), k
    for k, v in state.optimizer.state[state.flat.param].items():
        assert torch.equal(v, adam[k]), k
    trainer.train_step(state, _batch(3), cfg)
    assert (state.updates, state.notfinite_count, state.total_notfinite) == (2, 0, 1)
    assert any(not torch.equal(p.detach(), params[k]) for k, p in state.model.named_parameters())


def test_pt_checkpoints_cross_optimizer_layouts(weights, tmp_path):
    states = {}
    for flat in (False, True):
        cfg = _cfg(flat)
        states[flat] = _state(cfg, weights)
        trainer.train_step(states[flat], _batch(1), cfg)
    for src in (False, True):
        path = ckpt_lib.save(str(tmp_path), states[src], step=1, name=f"flat_{src}")
        dst = trainer.create_train_state(_cfg(not src), IMG, "cpu",
                                         model=CoPoNeRF(ModelConfig(**MODEL), image_size=IMG))
        ckpt_lib.restore_into(dst, path)
        assert (dst.step, dst.updates) == (1, 1)
        a, b = optim.adam_state(dst), optim.adam_state(states[src])
        for (k, p), q in zip(dst.model.named_parameters(), states[src].model.parameters()):
            assert torch.equal(p.detach(), q.detach()), k
            for m in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(a[k][m], b[k][m]), (k, m)
        if dst.flat is not None:
            for p, v in zip(dst.model.parameters(), dst.flat.split(dst.flat.param.detach()).values()):
                assert p.data_ptr() == v.data_ptr()
        if src:
            # a state of other widths raises before anything loads (seeded
            # weights: an unfilled model's memory may hold NaN, never equal)
            other = _cfg(True)
            other = dataclasses.replace(other, model=dataclasses.replace(other.model, hidden_dim=64))
            dst = trainer.create_train_state(other, IMG, "cpu",
                                             model=init_weights(CoPoNeRF(other.model, image_size=IMG), seed=1))
            before = {k: v.clone() for k, v in dst.model.state_dict().items()}
            with pytest.raises(ValueError, match="flat Adam state"):
                ckpt_lib._saved_moments(path, torch.load(path, weights_only=True)["optimizer"], dst.model, 1)
            with pytest.raises(ValueError, match="do not fit"):
                ckpt_lib.restore_into(dst, path)
            assert all(torch.equal(v, before[k]) for k, v in dst.model.state_dict().items())
        os.remove(path)             # about 1.2 GB


def test_flat_mesh_step_matches_per_leaf_mesh_step(weights):
    with tempfile.TemporaryDirectory() as d:
        pmesh.init_distributed("gloo", 0, 1, f"file://{d}/rendezvous")
        try:
            mesh = pmesh.make_mesh()
            states = {}
            for flat in (False, True):
                cfg = _cfg(flat)
                states[flat] = _state(cfg, weights)
                pmesh.replicate(mesh, states[flat].model)
                trainer.train_step(states[flat], _batch(1), cfg, mesh=mesh)
        finally:
            torch.distributed.destroy_process_group()
    _assert_states_agree(states[True], states[False], 1e-6)
    assert states[True].flat.param.grad is states[True].flat.grad
