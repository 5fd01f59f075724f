"""Data-parallel training of the port (``coponerf_tpu_torch/parallel``) on
gloo ranks on the CPU, held to the JAX package's mesh step and to the
port's own one-rank step on the concatenated batch.

The JAX package's step on a device mesh is its single-device step on the
global batch (``__graft_entry__.py`` gate 4), so N ranks must give what one
rank gives on all their shares together: the BatchNorm statistics, the
losses' mask sums and the gradients are reduced over the ranks.  Batches
are ``tests/test_model.py``'s (2 pairs of 32^2, 16 rays) at a narrow
depth (UFC (1, 1, 1), 8 samples); the spawned ranks run
``tests/torch_dist_helpers.py``.

Bounds, each with its largest reading on this host:
  - 2 ranks against JAX's 2-device mesh step (exact config, pose + cycle +
    SSIM, one step): ``tests/test_torch_train_exact.py``'s bounds;
  - N ranks against one rank, pose term off (at random weights the pose
    head amplifies round-off by orders of magnitude, see
    ``tests/test_torch_train_fast.py``).  Exact config: the first step's
    losses 1e-5 relative (2.4e-6) and grad norm 1e-4 (5.4e-6), from f32
    sums in another order only (the BatchNorm statistics as a mean of the
    ranks' means, the gradient as a mean of the ranks'); the second
    step's losses 1e-4 (5.8e-5) and grad norm 1e-2 (1.7e-3): Adam's first
    update is about lr * sign(g), so a gradient entry near 0 whose sign
    differs moves its parameter 2 lr apart; after two steps the mean
    |parameter difference| 1 % of lr (0.33 %).  Fast config (bf16 UFC and
    sampled latents): an f32 round-off difference flips single bf16
    roundings, so the losses are held at bf16 level, 2e-2 (first step
    2.4e-3, second 3.0e-3), the grad norm at 1e-2 in the first step
    (5.1e-4) and 5e-2 in the second (1.8e-2), the parameters at 5 % of lr
    (2.6 %).
"""

import collections
import os
import shutil
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist

from coponerf_tpu.config import Config as JConfig
from coponerf_tpu.config import LossConfig as JLossConfig
from coponerf_tpu.config import ModelConfig as JModelConfig
from coponerf_tpu.config import TrainConfig as JTrainConfig
from coponerf_tpu.data.synthetic import make_batch as j_make_batch
from coponerf_tpu.models import CoPoNeRF as JaxCoPoNeRF
from coponerf_tpu.parallel.mesh import make_mesh as j_make_mesh
from coponerf_tpu.parallel.mesh import replicate as j_replicate
from coponerf_tpu.parallel.mesh import shard_batch as j_shard_batch
from coponerf_tpu.training.trainer import TrainState, make_optimizer, make_train_step
from coponerf_tpu.utils.fast_init import fast_init
from coponerf_tpu_torch.config import Config, LossConfig, ModelConfig, TrainConfig
from coponerf_tpu_torch.data.loader import PrefetchLoader
from coponerf_tpu_torch.models import CoPoNeRF
from coponerf_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh, shard_batch
from coponerf_tpu_torch.training import trainer
from coponerf_tpu_torch.utils.convert import convert
from torch_dist_helpers import IndexDataset, launch, load_model, take_steps, train_rank
from torch_step_helpers import (
    IMG,
    LR,
    _adam_mu,
    check_exact_gradients,
    check_exact_losses_and_grad_norm,
    check_exact_updates_and_bn_stats,
)

torch.set_num_threads(2)

MODEL = dict(mask_upsample=IMG, npoints=8, ufc_layer_nums=(1, 1, 1))
FAST = dict(MODEL, fast_sampling=True, compute_dtype="bfloat16")
ALL_LOSSES = dict(pose=True, cycle=True, ssim=True)
NO_POSE = dict(cycle=True, ssim=True)
BATCH = dict(batch_size=2, image_size=IMG, n_rays=16)      # tests/test_model.py:80
SEEDS = (1, 2)
COUNTERS = ("step", "updates", "total_notfinite")
# name -> (model, mesh shape, mesh axes): the N-rank runs held to one rank
LAYOUTS = {"exact-2": (MODEL, (2,), ("data",)), "fast-2": (FAST, (2,), ("data",)),
           "exact-2x2": (MODEL, (2, 2), ("data", "rays"))}
# (first step's losses, its grad norm, second step's losses, its grad norm,
# mean |parameter difference| after two steps over lr)
BOUNDS = {"exact": (1e-5, 1e-4, 1e-4, 1e-2, 1e-2), "fast": (2e-2, 1e-2, 2e-2, 5e-2, 5e-2)}


def port_cfg(model_kw, loss_kw):
    return Config(model=ModelConfig(**model_kw), loss=LossConfig(**loss_kw),
                  train=TrainConfig(lr=LR, steps_per_epoch=100))


def jax_mesh_step(jm, variables, batch_np):
    """JAX's train step on a 2-device ``data`` mesh (``tests/test_model.py:66-99``):
    (its state after one step {params, batch_stats, mu}, its metrics)."""
    jcfg = JConfig(model=jm.cfg, loss=JLossConfig(**ALL_LOSSES), train=JTrainConfig(lr=LR))
    state = TrainState.create(apply_fn=jm.apply, params=variables["params"], batch_stats=variables["batch_stats"],
                              tx=make_optimizer(jcfg, steps_per_epoch=100))
    mesh = j_make_mesh((2,), ("data",), devices=jax.devices()[:2])
    state, metrics = make_train_step(jcfg)(j_replicate(mesh, state),
                                          j_shard_batch(mesh, jax.tree.map(jnp.asarray, batch_np)))
    after = {"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats),
             "mu": jax.device_get(_adam_mu(state.opt_state))}
    return after, {k: float(v) for k, v in metrics.items()}


def saved_state(path, model_kw, metrics):
    """A ``TrainState`` stand-in for the checks of ``torch_step_helpers``:
    the model and Adam's first moments a rank saved, its counters."""
    saved = torch.load(path, weights_only=True)
    model = CoPoNeRF(ModelConfig(**model_kw), image_size=IMG)
    model.load_state_dict(saved["model"], strict=True)
    named = dict(model.named_parameters())
    # as torch.optim's state, a parameter without a gradient maps to {}
    opt = types.SimpleNamespace(state=collections.defaultdict(dict, {named[k]: {"exp_avg": v}
                                                                     for k, v in saved["mu"].items()}))
    return types.SimpleNamespace(model=model, optimizer=opt, **{k: metrics[k] for k in COUNTERS})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-rank run of the module, launched in the background while
    this process computes JAX's mesh step and the one-rank references."""
    tmp = tmp_path_factory.mktemp("parallel")
    batch_np = j_make_batch(seed=SEEDS[0], **BATCH)[0]
    jm = JaxCoPoNeRF(JModelConfig(**MODEL))
    variables = fast_init(jm, jax.tree.map(jnp.asarray, batch_np), val=False, train=True)
    before = jax.tree.map(np.array, variables)
    weights = str(tmp / "weights.pt")
    torch.save(convert(before), weights)

    def launch_all():
        out = {"jax": launch(train_rank, 2, tmp, port_cfg(MODEL, ALL_LOSSES), IMG, weights, BATCH, SEEDS[:1], (2,),
                             ("data",), str(tmp / "jax.pt"), True)}
        for name, (model_kw, shape, axes) in LAYOUTS.items():
            # the 2 x 2 layout takes a third step in which rank 1's gradient is NaN
            nan = (1, 2) if name == "exact-2x2" else ()
            seeds = SEEDS + (3,) if nan else SEEDS
            out[name] = launch(train_rank, int(np.prod(shape)), tmp, port_cfg(model_kw, NO_POSE), IMG, weights,
                               BATCH, seeds, shape, axes, str(tmp / f"{name}.pt"), False, *nan)
        return out

    with ThreadPoolExecutor(1) as pool:
        launched = pool.submit(launch_all)
        jax_after, jax_metrics = jax_mesh_step(jm, variables, batch_np)
        refs = {}
        for name, model_kw in (("exact", MODEL), ("fast", FAST)):
            cfg = port_cfg(model_kw, NO_POSE)
            state = trainer.create_train_state(cfg, IMG, "cpu", model=load_model(cfg.model, IMG, weights))
            refs[name] = (take_steps(state, cfg, BATCH, SEEDS)[0], state.model.state_dict())
        ranks = launched.result()
    port = saved_state(tmp / "jax.pt", MODEL, ranks["jax"][0]["metrics"][0])
    yield dict(tmp=tmp, weights=weights, before=before, jax_after=jax_after, jax_metrics=jax_metrics, port_after=port, refs=refs,
               ranks=ranks)
    shutil.rmtree(tmp)      # about 2 GB of saved states


def test_two_rank_step_losses_and_grad_norm_match_jax_mesh(runs):
    ranks = runs["ranks"]["jax"]
    got = {k: v for k, v in ranks[0]["metrics"][0].items() if k not in COUNTERS}
    check_exact_losses_and_grad_norm(runs["jax_metrics"], got, runs["port_after"])
    np.testing.assert_equal(ranks[1]["metrics"], ranks[0]["metrics"])


def test_two_rank_step_gradients_match_jax_mesh_leaf_by_leaf(runs):
    check_exact_gradients(runs["jax_after"], runs["port_after"])


def test_two_rank_step_updates_params_and_bn_stats_like_jax_mesh(runs):
    check_exact_updates_and_bn_stats(runs["before"], runs["jax_after"], runs["port_after"])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_n_ranks_match_one_rank_on_the_global_batch(runs, layout):
    """Both steps' losses and grad norms, and the parameters after them,
    against one rank's steps on the same global batches."""
    kind = layout.split("-")[0]
    ref_metrics, ref_sd = runs["refs"][kind]
    loss1, norm1, loss2, norm2, params = BOUNDS[kind]
    got = runs["ranks"][layout][0]["metrics"]
    for step, (g, r, lb, nb) in enumerate(zip(got, ref_metrics, (loss1, loss2), (norm1, norm2))):
        assert [g[k] for k in COUNTERS] == [step + 1, step + 1, 0]
        for k in r:
            if k not in COUNTERS:
                bound = nb if k == "grad_norm" else lb
                assert abs(g[k] - r[k]) <= bound * abs(r[k]), (step, k, g[k], r[k])
    sd = torch.load(runs["tmp"] / f"{layout}.pt", weights_only=True)["model"]
    names = dict(CoPoNeRF(ModelConfig(**MODEL), image_size=IMG).named_parameters())
    diff = sum(float((sd[k] - ref_sd[k]).abs().sum()) for k in names)
    count = sum(ref_sd[k].numel() for k in names)
    assert diff / count <= params * LR, diff / count / LR


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_every_rank_holds_the_same_state(runs, layout):
    """After every step each rank's parameters are bit for bit rank 0's,
    and so are the BatchNorm statistics and the metrics at the end."""
    ranks = runs["ranks"][layout]
    assert len(ranks) == int(np.prod(LAYOUTS[layout][1]))
    for r in ranks[1:]:
        assert r["digests"] == ranks[0]["digests"]
        assert r["buffers"] == ranks[0]["buffers"]
        np.testing.assert_equal(r["metrics"], ranks[0]["metrics"])     # NaN equals NaN here


def test_nonfinite_gradient_on_one_rank_skips_the_step_on_every_rank(runs):
    """A NaN gradient on rank 1 alone (the third step of the 2 x 2 run):
    every rank skips the update (counters and parameters unmoved)."""
    for r in runs["ranks"]["exact-2x2"]:
        last = r["metrics"][-1]
        assert [last[k] for k in COUNTERS] == [3, 2, 1]
        assert not np.isfinite(last["grad_norm"])
        assert r["digests"][2] == r["digests"][1] != r["digests"][0]


def test_one_rank_mesh_step_is_the_plain_step_bit_for_bit(runs, tmp_path):
    """A mesh of one rank runs every collective of the step (over one
    rank: the identity) and gives the plain step's metrics and parameters
    bit for bit; ``make_mesh`` reads -1 and refuses a shape that does not
    cover the ranks."""
    cfg = port_cfg(MODEL, ALL_LOSSES)
    batch_kw = dict(BATCH, batch_size=1)
    init_distributed("gloo", 0, 1, f"file://{tmp_path}/rendezvous")
    try:
        mesh = make_mesh()
        assert (mesh.shape, mesh.axes, mesh.rank, mesh.world_size) == ((1,), ("data",), 0, 1)
        with pytest.raises(ValueError):
            make_mesh((2,), ("data",))
        model, plain = (load_model(cfg.model, IMG, runs["weights"]) for _ in range(2))
        got = take_steps(trainer.create_train_state(cfg, IMG, "cpu", model=model), cfg, batch_kw, SEEDS, mesh=mesh)
    finally:
        dist.destroy_process_group()
    want = take_steps(trainer.create_train_state(cfg, IMG, "cpu", model=plain), cfg, batch_kw, SEEDS)
    assert got == want


def _mesh(shape, axes, rank):
    return Mesh(shape=shape, axes=axes, rank=rank, world_size=int(np.prod(shape)), groups={})


def test_other_ranks_outwait_a_rank0_validation_longer_than_the_collective_timeout(tmp_path):
    """Rank 0 alone checkpoints and validates; with a collective timeout of
    2 s its validation sleeps 5 s, and rank 1, which waits for it on the
    group's store and not in the next step's all-reduce, goes on with it:
    both take three steps, rank 0 validates after steps 1 and 2."""
    from coponerf_tpu_torch.parallel.launch import run_ranks
    from torch_dist_helpers import slow_rank0_rank

    got = run_ranks(slow_rank0_rank, 2, "gloo", f"file://{tmp_path}/rendezvous", args=(str(tmp_path), 5.0),
                    threads=1, deadline_s=120.0, timeout_s=2.0)
    assert got == [(3, [1, 2]), (3, [])]
    assert sorted(os.listdir(tmp_path / "slow" / "checkpoints")) == ["model_current.pt", "model_final.pt"]


def test_shard_batch_cuts_rows_on_data_and_query_rays_on_rays():
    batch = j_make_batch(seed=0, **dict(BATCH, n_rays=8))[0]
    parts = [shard_batch(_mesh((2, 2), ("data", "rays"), r), batch) for r in range(4)]
    for r, part in enumerate(parts):
        d, s = divmod(r, 2)
        np.testing.assert_array_equal(part["context"]["rgb"], batch["context"]["rgb"][d:d + 1])
        np.testing.assert_array_equal(part["query"]["cam2world"], batch["query"]["cam2world"][d:d + 1])
        for k in ("uv", "rgb"):
            np.testing.assert_array_equal(part["query"][k], batch["query"][k][d:d + 1, :, 4 * s:4 * s + 4])
    with pytest.raises(ValueError):
        shard_batch(_mesh((3,), ("data",), 0), batch)
    with pytest.raises(ValueError):
        shard_batch(_mesh((1, 3), ("data", "rays"), 0), batch)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_gives_each_rank_its_rows_of_the_same_global_batches(num_workers):
    """``PrefetchLoader(rank, world)``: the ranks' batches, concatenated,
    are the one-rank loader's global batches, in its shuffled order."""
    ds = IndexDataset(12)
    kw = dict(batch_size=4, shuffle=True, seed=3, num_workers=num_workers)

    def first(loader, n=5):
        it = iter(loader)
        out = [next(it)[0]["i"] for _ in range(n)]
        loader.close()
        return out

    whole = first(PrefetchLoader(ds, **kw))
    parts = [first(PrefetchLoader(ds, rank=r, world=2, **kw)) for r in range(2)]
    for i, w in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([parts[0][i], parts[1][i]]), w)
    assert len({tuple(w) for w in whole}) > 1
    with pytest.raises(ValueError):
        PrefetchLoader(ds, batch_size=3, world=2)
