"""The JAX package's checkpoints (``.npz``) in the port
(``coponerf_tpu_torch/utils/jax_checkpoint.py``), on the CPU.

  - JAX's own ``save`` writes a state in each of its four layouts (loop
    or ``ufc_scan`` UFC, per-leaf or ``flat_optimizer`` Adam state) with
    seeded moments and the counters ``__step__`` 12, count 7,
    ``notfinite_count`` 2, ``total_notfinite`` 5, ``last_finite`` False;
    the port's ``restore_into`` gives the same weights, BatchNorm
    statistics, moments and counters bit for bit, after the layout change.
    Its learning rate at the restored count is JAX's schedule at the
    file's count to f32 round-off (the port takes the power in f64, optax
    in f32: one ulp at count 7);
  - the reverse: a port state with seeded Adam state, written by the
    port's ``save``, restores into a JAX state through JAX's own
    ``restore_into`` bit for bit;
  - a malformed file raises and leaves the port's state as it was;
  - one exact-config step on both sides after the restore (the file's
    only JAX step) at the bounds of ``tests/test_torch_train_exact.py``:
    losses 1e-4 relative (the pose loss 1e-3), grad norm 1e-2, BatchNorm
    statistics 1e-4 of the leaf's max, and the parameter updates' mean
    |difference| below 1 % of the mean |update| (1.2e-4 of it; with Adam's
    step restored as 4 in place of 7 it reads 10 %).  The restored
    moments make the update: with fresh moments it is about lr * sign(g),
    here it is of the moments' own size.

The model is the narrow one of ``tests/torch_step_helpers.py`` (97 M
parameters all the same, most in the pose head: each file is about
1.2 GB and is deleted when its test ends; the malformed cases derive
theirs one at a time, member by member, from one source file).
"""

import dataclasses
import os
import shutil
import types
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coponerf_tpu.config import Config as JConfig
from coponerf_tpu.config import ModelConfig as JModelConfig
from coponerf_tpu.config import TrainConfig as JTrainConfig
from coponerf_tpu.models.ufc import stack_ufc_params, unstack_ufc_params
from coponerf_tpu.training import checkpoint as jckpt
from coponerf_tpu.training.trainer import TrainState, make_optimizer
from coponerf_tpu_torch.config import Config, ModelConfig, TrainConfig
from coponerf_tpu_torch.models import CoPoNeRF
from coponerf_tpu_torch.training import checkpoint as ckpt_lib
from coponerf_tpu_torch.training import optim, trainer
from coponerf_tpu_torch.utils import jax_checkpoint
from coponerf_tpu_torch.utils.convert import convert, flax_path
from torch_step_helpers import IMG, LR, jax_model_and_batch, leaf, to_flax_layout

torch.set_num_threads(2)

UFC = "feature_cost_aggregation"
LAYERS = (2, 1, 1)                  # two layers in stage 0: the scan layout stacks them
LAYOUT_MODEL = dict(mask_upsample=IMG, npoints=8, ufc_layer_nums=LAYERS)
STEPS_PER_EPOCH = 3                 # count 7 is in epoch 2: lr x 0.95^2
STEP, COUNT, NOTFINITE, TOTAL = 12, 7, 2, 5


def port_cfg(model_kw, **loss):
    from coponerf_tpu_torch.config import LossConfig

    return Config(model=ModelConfig(**model_kw), loss=LossConfig(**loss),
                  train=TrainConfig(lr=LR, steps_per_epoch=STEPS_PER_EPOCH))


def fresh_port_state(cfg, image_size=IMG):
    return trainer.create_train_state(cfg, image_size, "cpu", model=CoPoNeRF(cfg.model, image_size=image_size))


def seeded_moments(shapes, seed):
    """Per leaf: mu ~ 1e-4 N(0, 1) and nu = mu^2 + 1e-8 U(0, 1), so that the
    update an Adam step makes from them is of the size of a real run's."""
    rng = np.random.RandomState(seed)
    mu = [(1e-4 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    nu = [(m.astype(np.float64) ** 2 + 1e-8 * rng.uniform(size=m.shape)).astype(np.float32) for m in mu]
    return mu, nu


def jax_state(variables, scan, flat, model_kw, seed=0):
    """A JAX ``TrainState`` of the layout, its moments seeded, its counters set."""
    params, stats = variables["params"], variables["batch_stats"]
    if scan:
        params = {**params, UFC: stack_ufc_params(params[UFC], model_kw["ufc_layer_nums"])}
    jcfg = JConfig(model=JModelConfig(**model_kw, ufc_scan=scan),
                   train=JTrainConfig(lr=LR, flat_optimizer=flat))
    state = TrainState.create(apply_fn=None, params=params, batch_stats=stats,
                              tx=make_optimizer(jcfg, steps_per_epoch=STEPS_PER_EPOCH))
    leaves, treedef = jax.tree_util.tree_flatten(state.opt_state)
    n = (len(leaves) - 5) // 2
    mu, nu = seeded_moments([np.shape(x) for x in leaves[4:4 + n]], seed)
    leaves = [np.int32(NOTFINITE), np.bool_(False), np.int32(TOTAL), np.int32(COUNT), *mu, *nu, np.int32(COUNT)]
    return state.replace(step=STEP, opt_state=jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in leaves]))


def jax_moments_loop_layout(state, scan, flat):
    """(mu, nu) of a JAX state as params trees in the loop layout, through
    JAX's own ``ravel_pytree`` and ``unstack_ufc_params``."""
    from jax.flatten_util import ravel_pytree

    adam = state.opt_state.inner_state[1][0]
    out = []
    for m in (adam.mu, adam.nu):
        if flat:
            m = ravel_pytree(state.params)[1](m)
        m = jax.device_get(m)
        if scan:
            m = {**m, UFC: unstack_ufc_params(m[UFC], LAYERS)}
        out.append(m)
    return out


def assert_port_holds(tstate, params, batch_stats, mu, nu, count):
    """The port's state (either optimizer layout) against loop-layout
    trees, bit for bit."""
    variables = {"params": params, "batch_stats": batch_stats}
    for key, t in tstate.model.state_dict().items():
        path, _ = flax_path(key, tuple(t.shape))
        np.testing.assert_array_equal(to_flax_layout(key, t.numpy()), leaf(variables, path), err_msg=key)
    adam = optim.adam_state(tstate)
    for key, p in tstate.model.named_parameters():
        path, _ = flax_path(key, tuple(p.shape))
        st = adam[key]
        np.testing.assert_array_equal(to_flax_layout(key, st["exp_avg"].numpy()), leaf(mu, path[1:]), err_msg=key)
        np.testing.assert_array_equal(to_flax_layout(key, st["exp_avg_sq"].numpy()), leaf(nu, path[1:]),
                                      err_msg=key)
        assert st["step"].item() == count, key


def jax_lr(count):
    import optax

    schedule = optax.exponential_decay(init_value=LR, transition_steps=STEPS_PER_EPOCH, decay_rate=0.95,
                                       staircase=True)
    return float(schedule(jnp.int32(count)))


@pytest.fixture(scope="module")
def layout_variables():
    """Seeded JAX variables of the layout tests' model, as numpy."""
    _, variables, _, _ = jax_model_and_batch(LAYOUT_MODEL, seed=0)
    return jax.tree.map(np.array, variables)


@pytest.mark.parametrize("flat", [False, True], ids=["per_leaf", "flat_optimizer"])
@pytest.mark.parametrize("scan", [False, True], ids=["loop", "ufc_scan"])
def test_port_restores_every_jax_layout_bit_for_bit(layout_variables, scan, flat, tmp_path):
    state = jax_state(layout_variables, scan, flat, LAYOUT_MODEL, seed=1 + 2 * scan + flat)
    path = jckpt.save(str(tmp_path), state, step=STEP)
    try:
        n = len(jax.tree_util.tree_leaves(state.params))
        assert len(jckpt.load(path)[2]) == (7 if flat else 2 * n + 5)
        cfg = port_cfg(LAYOUT_MODEL)
        tstate = ckpt_lib.restore_into(fresh_port_state(cfg), path)
    finally:
        os.remove(path)
    mu, nu = jax_moments_loop_layout(state, scan, flat)
    assert_port_holds(tstate, layout_variables["params"], layout_variables["batch_stats"], mu, nu, COUNT)
    assert (tstate.step, tstate.updates, tstate.notfinite_count, tstate.total_notfinite) == (STEP, COUNT, NOTFINITE,
                                                                                             TOTAL)
    lr = trainer.learning_rate(cfg, tstate.updates)
    assert lr == trainer.learning_rate(cfg, COUNT) and abs(lr - jax_lr(COUNT)) <= 1e-6 * jax_lr(COUNT)


def test_jax_restores_a_port_checkpoint_bit_for_bit(layout_variables, tmp_path):
    """The port's ``save`` of a state with seeded Adam state (other weights
    than the JAX state's) through JAX's ``restore_into`` into its default
    layout."""
    from coponerf_tpu_torch.utils.init import init_weights

    cfg = port_cfg(LAYOUT_MODEL)
    tstate = trainer.create_train_state(cfg, IMG, "cpu", model=init_weights(CoPoNeRF(cfg.model, image_size=IMG),
                                                                             seed=3))
    named = list(tstate.model.named_parameters())
    mu, nu = seeded_moments([tuple(p.shape) for _, p in named], seed=4)
    for (_, p), m, v in zip(named, mu, nu):
        tstate.optimizer.state[p] = {"step": torch.tensor(float(COUNT)), "exp_avg": torch.from_numpy(m),
                                     "exp_avg_sq": torch.from_numpy(v)}
    tstate.step, tstate.updates, tstate.notfinite_count, tstate.total_notfinite = STEP, COUNT, NOTFINITE, TOTAL
    path = jax_checkpoint.save(str(tmp_path), tstate, step=STEP)
    try:
        target = jax_state(layout_variables, False, False, LAYOUT_MODEL)
        got = jckpt.restore_into(target, path)
    finally:
        os.remove(path)
    assert int(got.step) == STEP
    fin = got.opt_state
    assert (int(fin.notfinite_count), bool(fin.last_finite), int(fin.total_notfinite)) == (NOTFINITE, False, TOTAL)
    adam, sched = fin.inner_state[1]
    assert int(adam.count) == int(sched.count) == COUNT
    assert jax.tree_util.tree_structure(got.opt_state) == jax.tree_util.tree_structure(target.opt_state)
    for leaf_ in jax.tree_util.tree_leaves(got.opt_state):
        assert isinstance(leaf_, jax.Array)
    assert_port_holds(tstate, jax.device_get(got.params), jax.device_get(got.batch_stats), jax.device_get(adam.mu),
                      jax.device_get(adam.nu), COUNT)


@pytest.mark.parametrize("scan, flat", [(False, True), (True, False), (True, True)],
                         ids=["flat_optimizer", "ufc_scan", "ufc_scan_flat_optimizer"])
def test_port_writes_each_jax_layout_and_reads_it_back(layout_variables, scan, flat, tmp_path):
    """A port state of the configuration (``ufc_scan``, ``flat_optimizer``)
    with seeded Adam state, written by the port's ``save`` in that
    configuration's layout; JAX's ``restore_into`` takes it into a JAX
    state of the same configuration, whose trees (unstacked and unraveled
    by JAX's own functions) hold the port's values bit for bit; the port
    reads the file back into a fresh state of the configuration bit for
    bit."""
    from coponerf_tpu_torch.utils.init import init_weights

    base = port_cfg(dict(LAYOUT_MODEL, ufc_scan=scan))
    cfg = dataclasses.replace(base, train=dataclasses.replace(base.train, flat_optimizer=flat))
    tstate = trainer.create_train_state(cfg, IMG, "cpu", model=init_weights(CoPoNeRF(cfg.model, image_size=IMG),
                                                                             seed=3))
    assert (tstate.flat is not None) == flat
    named = list(tstate.model.named_parameters())
    mu, nu = seeded_moments([tuple(p.shape) for _, p in named], seed=6 + scan + 2 * flat)
    optim.load_adam_state(tstate, {k: (torch.from_numpy(m), torch.from_numpy(v))
                                     for (k, _), m, v in zip(named, mu, nu)}, COUNT)
    tstate.step, tstate.updates, tstate.notfinite_count, tstate.total_notfinite = STEP, COUNT, NOTFINITE, TOTAL
    path = jax_checkpoint.save(str(tmp_path), tstate, step=STEP)
    try:
        target = jax_state(layout_variables, scan, flat, LAYOUT_MODEL)
        n = len(jax.tree_util.tree_leaves(target.params))
        assert len(jckpt.load(path)[2]) == (7 if flat else 2 * n + 5)
        got = jckpt.restore_into(target, path)
        back = ckpt_lib.restore_into(fresh_port_state(cfg), path)
    finally:
        os.remove(path)
    assert int(got.step) == STEP
    assert jax.tree_util.tree_structure(got.opt_state) == jax.tree_util.tree_structure(target.opt_state)
    assert jax.tree_util.tree_structure(got.params) == jax.tree_util.tree_structure(target.params)
    fin = got.opt_state
    assert (int(fin.notfinite_count), bool(fin.last_finite), int(fin.total_notfinite)) == (NOTFINITE, False, TOTAL)
    params = jax.device_get(got.params)
    if scan:
        params = {**params, UFC: unstack_ufc_params(params[UFC], LAYERS)}
    jmu, jnu = jax_moments_loop_layout(got, scan, flat)
    assert_port_holds(tstate, params, jax.device_get(got.batch_stats), jmu, jnu, COUNT)
    assert (back.flat is not None) == flat
    assert (back.step, back.updates, back.notfinite_count, back.total_notfinite) == (STEP, COUNT, NOTFINITE, TOTAL)
    assert_port_holds(back, params, jax.device_get(got.batch_stats), jmu, jnu, COUNT)


def _rewrite(src, dst, drop=(), put=None):
    """``src`` with the members ``drop`` left out and ``put``'s arrays
    written in, copied member by member (one in memory at a time)."""
    put = put or {}
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for name in zin.namelist():
            if name[:-len(".npy")] in drop or name[:-len(".npy")] in put:
                continue
            with zin.open(name) as f, zout.open(name, "w", force_zip64=True) as g:
                shutil.copyfileobj(f, g, 1 << 24)
        for key, v in put.items():
            with zout.open(key + ".npy", "w", force_zip64=True) as g:
                np.lib.format.write_array(g, np.asanyarray(v), allow_pickle=False)
    return dst


def _last_opt_key(path):
    with np.load(path) as data:
        return max(k for k in data.files if k.startswith("__opt__/"))


MALFORMED = {
    "truncated": (lambda src, dst: _rewrite(src, dst, drop=(_last_opt_key(src),)), "optimizer leaves"),
    "counts_disagree": (lambda src, dst: _rewrite(src, dst, put={_last_opt_key(src): np.int32(COUNT + 1)}),
                        "disagree"),
    "leaf_left_over": (lambda src, dst: _rewrite(src, dst, put={"params/extra/bias": np.zeros(3, np.float32)}),
                       "left over"),
    "leaf_missing": (lambda src, dst: _rewrite(src, dst, drop=("batch_stats/encoder/stem/bn/mean",)), "missing"),
    "image_size": (None, "shapes differ"),
}


@pytest.fixture(scope="module")
def malformed_source(tmp_path_factory):
    """The port's ``.npz`` of a state with Adam state at count 7, written
    once for the malformed cases (each derives its file from it) and
    deleted with the module."""
    cfg = port_cfg(LAYOUT_MODEL)
    src = fresh_port_state(cfg)
    for p in src.model.parameters():
        src.optimizer.state[p] = {"step": torch.tensor(float(COUNT)), "exp_avg": torch.full_like(p, 1e-3),
                                  "exp_avg_sq": torch.full_like(p, 1e-6)}
    src.step, src.updates = STEP, COUNT
    path = jax_checkpoint.save(str(tmp_path_factory.mktemp("source")), src, step=STEP)
    del src
    yield path
    os.remove(path)


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_file_raises_and_restores_nothing(case, malformed_source, tmp_path):
    """A truncated optimizer leaf list, Adam's and the schedule's counts
    apart, a leaf left over or missing, and the file of another image size
    each raise ``ValueError`` naming the fault; the state keeps its
    weights, Adam state and counters."""
    make, match = MALFORMED[case]
    cfg = port_cfg(LAYOUT_MODEL)
    image_size = 64 if case == "image_size" else IMG
    target = trainer.create_train_state(cfg, image_size, "cpu")       # seeded weights
    before = {k: v.clone() for k, v in target.model.state_dict().items()}
    path = malformed_source if make is None else make(malformed_source, str(tmp_path / "bad.npz"))
    try:
        with pytest.raises(ValueError, match=match):
            ckpt_lib.restore_into(target, path)
    finally:
        if path != malformed_source:
            os.remove(path)
    for k, v in target.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert len(target.optimizer.state) == 0
    assert (target.step, target.updates, target.notfinite_count, target.total_notfinite) == (0, 0, 0, 0)


def test_weights_only_file_starts_adam_fresh(layout_variables, tmp_path, capsys):
    """A file without optimizer leaves (the JAX package's pre-round-2
    checkpoints) restores the weights and the step; Adam starts fresh."""
    path = jckpt.save(str(tmp_path), types.SimpleNamespace(params=layout_variables["params"],
                                                           batch_stats=layout_variables["batch_stats"]), step=STEP)
    cfg = port_cfg(LAYOUT_MODEL)
    tstate = fresh_port_state(cfg)
    p0 = next(tstate.model.parameters())
    tstate.optimizer.state[p0] = {"step": torch.tensor(3.0), "exp_avg": torch.ones_like(p0),
                                  "exp_avg_sq": torch.ones_like(p0)}
    tstate.updates, tstate.total_notfinite = 3, 1
    try:
        ckpt_lib.restore_into(tstate, path)
    finally:
        os.remove(path)
    assert "Adam starts fresh" in capsys.readouterr().out
    assert len(tstate.optimizer.state) == 0
    assert (tstate.step, tstate.updates, tstate.notfinite_count, tstate.total_notfinite) == (STEP, 0, 0, 0)
    want = convert(layout_variables)
    for k, v in tstate.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_exact_step_after_a_restore_matches_jax(tmp_path):
    """JAX's exact-config state with seeded moments, saved by JAX, restored
    by JAX (``restore_into``) and by the port; one step each on the same
    batch, with the pose, cycle and SSIM losses."""
    from coponerf_tpu.config import LossConfig as JLossConfig
    from coponerf_tpu.training.trainer import make_train_step
    from coponerf_tpu_torch.models import batch_to_torch
    from torch_step_helpers import update_and_stats_errors

    model_kw = dict(mask_upsample=IMG, npoints=8, ufc_layer_nums=(1, 1, 1))
    loss_kw = dict(pose=True, cycle=True, ssim=True)
    jm, variables, batch_np, batch = jax_model_and_batch(model_kw, seed=0)
    before = jax.tree.map(np.array, variables)
    source = jax_state(before, False, False, model_kw, seed=5)
    path = jckpt.save(str(tmp_path), source, step=STEP)
    try:
        cfg = port_cfg(model_kw, **loss_kw)
        tstate = ckpt_lib.restore_into(fresh_port_state(cfg), path)
        jcfg = JConfig(model=jm.cfg, loss=JLossConfig(**loss_kw), train=JTrainConfig(lr=LR))
        live = TrainState.create(apply_fn=jm.apply, params=variables["params"], batch_stats=variables["batch_stats"],
                                 tx=make_optimizer(jcfg, steps_per_epoch=STEPS_PER_EPOCH))
        jstate = jckpt.restore_into(live, path)
    finally:
        os.remove(path)
    jstate, jm_ = make_train_step(jcfg)(jstate, batch)
    jm_ = {k: float(v) for k, v in jm_.items()}
    tm = {k: float(v) for k, v in trainer.train_step(tstate, batch_to_torch(batch_np, "cpu"), cfg).items()}
    assert set(tm) == set(jm_)
    tm["total_less_pose"] = tm["total_train_loss"] - tm["pose_loss"]
    jm_["total_less_pose"] = jm_["total_train_loss"] - jm_["pose_loss"]
    for k in ("img_loss", "ssim_loss", "cycle_loss", "total_at_entropy", "total_less_pose"):
        assert abs(tm[k] - jm_[k]) <= 1e-4 * abs(jm_[k]), (k, tm[k], jm_[k])
    assert abs(tm["pose_loss"] - jm_["pose_loss"]) <= 1e-3 * abs(jm_["pose_loss"])
    assert abs(tm["grad_norm"] - jm_["grad_norm"]) <= 1e-2 * jm_["grad_norm"], (tm["grad_norm"], jm_["grad_norm"])
    assert (tstate.step, tstate.updates, tstate.notfinite_count, tstate.total_notfinite) == (STEP + 1, COUNT + 1, 0,
                                                                                             TOTAL)
    assert int(jstate.opt_state.inner_state[1][0].count) == COUNT + 1
    jax_after = {"params": jax.device_get(jstate.params), "batch_stats": jax.device_get(jstate.batch_stats)}
    mean_diff, _, bn = update_and_stats_errors(before, jax_after, tstate)
    paths = [flax_path(k, tuple(t.shape))[0] for k, t in tstate.model.named_parameters()]
    mean_update = float(np.concatenate([np.abs(leaf(jax_after, p) - leaf(before, p)).ravel() for p in paths]).mean())
    assert mean_update > 0.01 * LR
    assert mean_diff < 0.01 * mean_update, (mean_diff, mean_update)
    assert len(bn) == 2 * 36 and max(bn.values()) <= 1e-4, max(bn.items(), key=lambda kv: kv[1])
