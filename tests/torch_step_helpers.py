"""Shared by the port's whole-train-step tests: one JAX ``make_train_step``
and one port ``train_step`` from the same weights and batch, the pose
term's gradient through the encode on both sides, the leaf-by-leaf views
of their results, and the exact config's checks of one step (bounds in
``tests/test_torch_train_exact.py``'s docstring)."""

import numpy as np
import jax
import jax.numpy as jnp

from coponerf_tpu.config import Config as JConfig
from coponerf_tpu.config import LossConfig as JLossConfig
from coponerf_tpu.config import ModelConfig as JModelConfig
from coponerf_tpu.config import TrainConfig as JTrainConfig
from coponerf_tpu.models import CoPoNeRF as JaxCoPoNeRF
from coponerf_tpu.models.coponerf import IMAGENET_MEAN, IMAGENET_STD
from coponerf_tpu.training.trainer import TrainState, make_optimizer, make_train_step
from coponerf_tpu.utils.fast_init import fast_init
from coponerf_tpu_torch.config import Config, LossConfig, ModelConfig, TrainConfig
from coponerf_tpu_torch.data.synthetic import make_batch
from coponerf_tpu_torch.geometry import geodesic_rotation_distance, pose_inverse_4x4
from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
from coponerf_tpu_torch.training import trainer
from coponerf_tpu_torch.utils.convert import convert, flax_path

IMG = 32
LR = 1e-4


def leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def to_flax_layout(key, arr):
    """A port tensor in the flax leaf's layout (Dense/Conv weights)."""
    if key.endswith(".weight") and arr.ndim == 2:
        return arr.T
    if key.endswith(".weight") and arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    return arr


def _adam_mu(opt_state):
    found = [s.mu for s in jax.tree.leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    assert len(found) == 1
    return found[0]


def jax_model_and_batch(model_kw, seed):
    """(JAX model, its seeded variables, the numpy batch, the JAX batch)."""
    batch_np, _ = make_batch(batch_size=2, image_size=IMG, n_rays=16, seed=seed)
    batch = jax.tree.map(jnp.asarray, batch_np)
    jm = JaxCoPoNeRF(JModelConfig(**model_kw))
    return jm, fast_init(jm, batch, val=False, train=True), batch_np, batch


def run_both(model_kw, loss_kw, seed):
    """Returns (variables before, JAX after {params, batch_stats, mu}, JAX
    metrics, port TrainState after, port metrics)."""
    jm, variables, batch_np, batch = jax_model_and_batch(model_kw, seed)
    jcfg = JConfig(model=jm.cfg, loss=JLossConfig(**loss_kw), train=JTrainConfig(lr=LR))
    before = jax.tree.map(np.array, variables)          # copies: the step donates its state
    state = TrainState.create(apply_fn=jm.apply, params=variables["params"],
                              batch_stats=variables["batch_stats"], tx=make_optimizer(jcfg, steps_per_epoch=100))
    jstate, jmetrics = make_train_step(jcfg)(state, batch)
    jax_after = {"params": jax.device_get(jstate.params), "batch_stats": jax.device_get(jstate.batch_stats),
                 "mu": jax.device_get(_adam_mu(jstate.opt_state))}

    cfg = Config(model=ModelConfig(**model_kw), loss=LossConfig(**loss_kw),
                 train=TrainConfig(lr=LR, steps_per_epoch=100))
    port = CoPoNeRF(cfg.model, image_size=IMG)
    port.load_state_dict(convert(before), strict=True)
    tstate = trainer.create_train_state(cfg, IMG, "cpu", model=port)
    metrics = trainer.train_step(tstate, batch_to_torch(batch_np, "cpu"), cfg)
    return (before, jax_after, {k: float(v) for k, v in jmetrics.items()}, tstate,
            {k: float(v) for k, v in metrics.items()})


def _jax_tokens(m, batch):
    """The JAX encode (train mode) up to the pose head's input tokens, as in
    ``coponerf_tpu/models/coponerf.py:149-177``."""
    rgb = batch["context"]["rgb"]
    B, V, H, W, _ = rgb.shape
    rgb = ((rgb.reshape(B * V, H, W, 3) + 1.0) / 2.0 - IMAGENET_MEAN) / IMAGENET_STD
    bf16 = m.cfg.compute_dtype == "bfloat16"
    z_feats = m.encoder(rgb.astype(jnp.bfloat16 if bf16 else jnp.float32), train=True)
    if not bf16:
        z_feats = [z.astype(jnp.float32) for z in z_feats]
    feat_list, _, _ = m.feature_cost_aggregation(z_feats, V)
    return feat_list[-1].reshape(B * V, -1, feat_list[-1].shape[-1]).astype(jnp.float32)


def pose_term_encode_grads(model_kw, seed):
    """The pose term's gradient with respect to the encoder and UFC weights,
    from one shared cotangent on the pose head's input tokens.

    The port runs a train-mode encode, takes the pose loss of its rel_pose
    and the loss's gradient on the tokens (the cotangent), and pulls that
    cotangent back through its own encoder and UFC; the JAX package pulls
    the same cotangent back through its own.  Returns ({port key: (port
    gradient, JAX gradient)} in the flax layout for every parameter the
    tokens depend on, the tokens' max |port - JAX| over their max)."""
    import torch

    jm, variables, batch_np, batch = jax_model_and_batch(model_kw, seed)
    port = CoPoNeRF(ModelConfig(**model_kw), image_size=IMG)
    port.load_state_dict(convert(jax.tree.map(np.array, variables)), strict=True)
    seen = {}

    def keep_tokens(mod, args):
        seen["tokens"] = args[0]

    hook = port.cross_attention.register_forward_pre_hook(keep_tokens)
    tb = batch_to_torch(batch_np, "cpu")
    state = port.encode(tb, train=True)
    hook.remove()
    c2w = tb["context"]["cam2world"]
    gt = pose_inverse_4x4(c2w[:, 0]) @ c2w[:, 1]      # as the model's gt_rel_pose
    rel = state.rel_pose
    pose = (geodesic_rotation_distance(rel[:, :3, :3], gt[:, :3, :3], eps=1e-7).mean()
            + torch.linalg.vector_norm(rel[:, :3, 3] - gt[:, :3, 3], dim=-1).mean())
    tokens = seen["tokens"]
    cot, = torch.autograd.grad(pose, tokens, retain_graph=True)
    named = [(k, p) for k, p in port.named_parameters() if k.startswith(("encoder.", "feature_cost_aggregation."))]
    got = torch.autograd.grad(tokens, [p for _, p in named], cot, allow_unused=True)

    def jax_tokens(params):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, batch,
                          method=_jax_tokens, mutable=["batch_stats"])
        return out

    jtok, vjp = jax.vjp(jax_tokens, variables["params"])
    jgrads, = vjp(jnp.asarray(cot.numpy()))
    out = {}
    for (key, p), g in zip(named, got):
        path, _ = flax_path(key, tuple(p.shape))
        g = np.zeros(tuple(p.shape), np.float32) if g is None else g.numpy()
        out[key] = (to_flax_layout(key, g), leaf(jgrads, path[1:]))
    jtok = np.asarray(jtok)
    return out, float(np.abs(tokens.detach().numpy() - jtok).max() / np.abs(jtok).max())


def gradient_cosines(jax_after, tstate):
    """{port key: cosine of the port's and JAX's first Adam moments} for the
    leaves any loss reaches; after one step each is 0.1 x the clipped
    gradient.  Leaves no loss reaches must be zero on both sides."""
    import torch

    out = {}
    for key, p in tstate.model.named_parameters():
        path, _ = flax_path(key, tuple(p.shape))
        ref = leaf(jax_after["mu"], path[1:])
        mom = tstate.optimizer.state[p].get("exp_avg", torch.zeros_like(p))   # no state: no gradient
        got = to_flax_layout(key, mom.numpy())
        denom = np.linalg.norm(got) * np.linalg.norm(ref)
        if denom == 0:
            assert np.abs(got).max() == 0 and np.abs(ref).max() == 0, key
            continue
        out[key] = float((got * ref).sum() / denom)
    return out


def update_and_stats_errors(before, jax_after, tstate):
    """(mean |port update - JAX update| over all parameters, max |update| of
    either side, {BN key: max abs error / max abs value of the running stat})."""
    diffs, count, biggest, bn = 0.0, 0, 0.0, {}
    for key, t in tstate.model.state_dict().items():
        path, _ = flax_path(key, tuple(t.shape))
        got = to_flax_layout(key, t.numpy())
        ref = leaf(jax_after, path)
        if path[0] == "batch_stats":
            bn[key] = float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6))
            continue
        old = leaf(before, path)
        d_port, d_jax = got - old, ref - old
        biggest = max(biggest, float(np.abs(d_port).max()), float(np.abs(d_jax).max()))
        diffs += float(np.abs(d_port - d_jax).sum())
        count += d_port.size
    return diffs / count, biggest, bn


def check_exact_losses_and_grad_norm(jm, tm, tstate):
    """The exact config's losses and pre-clip grad norm against JAX's."""
    assert set(tm) == set(jm)
    tm = dict(tm, total_less_pose=tm["total_train_loss"] - tm["pose_loss"])
    jm = dict(jm, total_less_pose=jm["total_train_loss"] - jm["pose_loss"])
    for k in ("img_loss", "ssim_loss", "cycle_loss", "total_at_entropy", "total_less_pose"):
        assert abs(tm[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, tm[k], jm[k])
    assert abs(tm["pose_loss"] - jm["pose_loss"]) <= 1e-3 * abs(jm["pose_loss"]), (tm["pose_loss"], jm["pose_loss"])
    assert abs(tm["grad_norm"] - jm["grad_norm"]) <= 1e-2 * jm["grad_norm"], (tm["grad_norm"], jm["grad_norm"])
    assert tstate.step == tstate.updates == 1 and tstate.total_notfinite == 0


def check_exact_gradients(jax_after, tstate):
    """Every gradient leaf's cosine with JAX's, through Adam's first moment."""
    cos = gradient_cosines(jax_after, tstate)
    assert len(cos) > 300
    assert min(cos.values()) >= 0.99, min(cos.items(), key=lambda kv: kv[1])


def check_exact_updates_and_bn_stats(before, jax_after, tstate):
    """The parameter updates and BatchNorm running statistics against JAX's."""
    mean_diff, biggest, bn = update_and_stats_errors(before, jax_after, tstate)
    assert biggest <= 1.001 * LR
    assert mean_diff < 0.01 * LR
    assert len(bn) == 2 * 36 and max(bn.values()) <= 1e-4, max(bn.items(), key=lambda kv: kv[1])
