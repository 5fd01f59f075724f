"""Rank functions of the port's multi-process tests, and their launcher.

Spawned ranks import this module, so it imports no JAX.  Each rank joins a
gloo group through a ``file://`` store under the test's temporary
directory, runs on one CPU thread, and returns numpy values; rank 0 writes
the states the tests compare to ``out_dir``.
"""

import hashlib
import uuid

import numpy as np
import torch

from coponerf_tpu_torch.data.synthetic import make_batch
from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
from coponerf_tpu_torch.parallel.launch import run_ranks
from coponerf_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
from coponerf_tpu_torch.parallel.render import render_ray_sharded
from coponerf_tpu_torch.training import trainer

DEADLINE_S = 300.0


def launch(fn, world, tmp_path, *args):
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; fails within
    ``DEADLINE_S`` with the failing rank's traceback, never hangs."""
    init = f"file://{tmp_path}/rendezvous_{uuid.uuid4().hex}"
    return run_ranks(fn, world, "gloo", init, args=args, threads=1, deadline_s=DEADLINE_S)


def load_model(cfg, image_size, weights, load=True):
    """The model of ``cfg`` with the state dict saved at ``weights`` (or its
    construction's init where ``load`` is False)."""
    model = CoPoNeRF(cfg, image_size=image_size)
    if load:
        model.load_state_dict(torch.load(weights, mmap=True, weights_only=True), strict=True)
    return model


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def save_state(path, state, moments):
    """The model's state dict and, with ``moments``, Adam's first moments by
    parameter name."""
    opt = state.optimizer
    mu = {k: opt.state[p]["exp_avg"] for k, p in state.model.named_parameters() if p in opt.state} if moments else {}
    torch.save({"model": state.model.state_dict(), "mu": mu}, path)


def take_steps(state, cfg, batch_kw, seeds, mesh=None, out=None, moments=False, nan_at=None):
    """One train step on each global batch ``make_batch(seed=s, **batch_kw)``
    (this rank's share under ``mesh``).  Before step ``nan_at`` a hook makes
    one gradient of this process non-finite.  Saves the state after the
    last step to ``out`` where given (``save_state``).  Returns (metrics of
    each step with the counters ``step``, ``updates`` and
    ``total_notfinite`` after it, a digest of the parameters after each
    step)."""
    metrics, digests = [], []
    for i, seed in enumerate(seeds):
        batch = make_batch(seed=seed, **batch_kw)[0]
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        hook = None
        if i == nan_at:
            hook = state.model.phi.lin_out.Dense_0.weight.register_hook(lambda g: torch.full_like(g, float("nan")))
        m = trainer.train_step(state, batch_to_torch(batch, "cpu"), cfg, mesh=mesh)
        if hook is not None:
            hook.remove()
        metrics.append({**{k: float(v) for k, v in m.items()}, "step": state.step, "updates": state.updates,
                        "total_notfinite": state.total_notfinite})
        digests.append(digest(state.model.parameters()))
    if out is not None:
        save_state(out, state, moments)
    return metrics, digests


def train_rank(rank, world, cfg, image_size, weights, batch_kw, seeds, mesh_shape, mesh_axes, out, moments,
               nan_rank=None, nan_at=None):
    """A data-parallel run on the mesh: rank 0 loads ``weights``, the others
    receive them (``replicate``); rank 0 saves the last state to ``out``.
    Returns this rank's metrics and
    parameter digests (``take_steps``) and a digest of its BatchNorm
    buffers."""
    mesh = make_mesh(mesh_shape, mesh_axes)
    model = load_model(cfg.model, image_size, weights, load=rank == 0)
    replicate(mesh, model)
    state = trainer.create_train_state(cfg, image_size, "cpu", model=model)
    metrics, digests = take_steps(state, cfg, batch_kw, seeds, mesh=mesh, out=out if rank == 0 else None,
                                  moments=moments, nan_at=nan_at if rank == nan_rank else None)
    return dict(metrics=metrics, digests=digests, buffers=digest(model.buffers()))


def render_rank(rank, world, cfg, image_size, weights, batch_kw, chunk):
    """The ray-sharded val render of one request over a ``rays`` mesh of
    every rank; returns the whole image's outputs as numpy."""
    mesh = make_mesh((-1,), ("rays",))
    model = load_model(cfg, image_size, weights, load=rank == 0).eval()
    replicate(mesh, model)
    batch = batch_to_torch(make_batch(**batch_kw)[0], "cpu")
    with torch.no_grad():
        state = model.encode(batch)
    out = render_ray_sharded(model, batch, state, mesh, chunk=chunk)
    return {k: np.asarray(v.numpy()) for k, v in out.items()}


class IndexDataset:
    """Items ``({"i": index},)``: a loader's batches show which rows it read."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return ({"i": np.array(i)},)


def slow_rank0_rank(rank, world, logdir, sleep_s):
    """``trainer.train`` for three steps on a stand-in model whose step is
    one all-reduce (the real step's collectives, without its cost), with a
    checkpoint and validation after steps 1 and 2; rank 0's validation of
    step 1 sleeps ``sleep_s``.  Returns (steps taken, the steps validated)."""
    import time

    import torch.distributed as dist

    from coponerf_tpu_torch.config import Config, TrainConfig

    def step(state, batch, cfg, mesh=None):
        x = torch.ones(1)
        dist.all_reduce(x)
        state.step += 1
        return {"total_train_loss": x[0]}

    trainer.train_step = step           # in this rank's process only
    validated = []

    def val_fn(state, step, logger):
        validated.append(step)
        if step == 1:
            time.sleep(sleep_s)

    model = torch.nn.Linear(2, 2)
    state = trainer.TrainState(model=model, optimizer=torch.optim.Adam(model.parameters()))
    cfg = Config(train=TrainConfig(steps_til_summary=1, epochs_til_ckpt=0, iters_til_ckpt=0), logging_root=logdir,
                 experiment_name="slow")
    trainer.train(cfg, [{}], num_steps=3, state=state, device="cpu", val_fn=val_fn, mesh=make_mesh())
    return state.step, validated
