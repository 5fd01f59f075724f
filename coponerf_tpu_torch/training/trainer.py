"""Training: one Adam step of the whole model per batch, and the loop.

Counterpart of ``coponerf_tpu/training/trainer.py:35-275``:
  - Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8), one group;
  - global-norm clipping in optax's form: ``g / norm * max_norm`` when
    ``norm >= max_norm`` (not ``clip_grad_norm_``'s ``norm + 1e-6``);
  - a per-epoch staircase decay ``lr * 0.95 ** (updates // steps_per_epoch)``
    counted in applied updates;
  - a step whose gradients hold any NaN/Inf applies nothing:
    ``optimizer.step()`` is not called, so neither Adam's state nor the
    schedule moves (optax ``apply_if_finite`` semantics).  The BatchNorm
    running statistics are updated by the forward all the same, as in the
    JAX step and the reference;
  - every parameter takes Adam's step, as every leaf does in optax: one
    that no loss reaches gets a zero gradient just before ``opt.step()``,
    so its moments decay and a moment restored from a JAX checkpoint moves
    it as it would there.  Those zeros stay out of the norm, the finite
    check, the clip and the all-reduce, where they change nothing;
  - checkpoints at the JAX loop's cadences and a JSONL metric log;
  - with ``TrainConfig.debug_nans`` the step raises ``FloatingPointError``
    at the first module whose output holds a NaN, and autograd's anomaly
    mode at the first backward operation that makes one, instead of
    skipping the step (the JAX package's ``jax_debug_nans``).

Under a mesh (``parallel/mesh.py``) each rank computes on its share of
the global batch, with the BatchNorm statistics and the losses' mask sums
of the global batch; after ``backward`` the gradients are averaged over
every rank (one flat all-reduce), so the norm, the finite check, the clip
and Adam see the global gradient and every rank takes the same branch and
the same update: the JAX package's mesh step, which is its single-device
step on the global batch.  Only rank 0 writes the log, the checkpoints and
the validation summaries; the other ranks wait for it on the group's store
(``parallel.mesh.wait_for_rank0``), outside any collective, so a slow
validation does not run into the collectives' timeout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from coponerf_tpu_torch.config import Config
from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
from coponerf_tpu_torch.parallel.mesh import (Mesh, attach_batch_norm, average_gradients, average_over_world,
                                              rank0_done, replicate, wait_for_rank0)
from coponerf_tpu_torch.training import checkpoint as ckpt_lib
from coponerf_tpu_torch.training.losses import lf_loss
from coponerf_tpu_torch.utils.init import init_weights


@dataclasses.dataclass
class TrainState:
    model: CoPoNeRF
    optimizer: torch.optim.Optimizer
    step: int = 0               # train steps taken, skipped ones included
    updates: int = 0            # optimizer updates applied (Adam's count)
    notfinite_count: int = 0    # consecutive skipped steps
    total_notfinite: int = 0    # all skipped steps


def make_optimizer(model: torch.nn.Module, cfg: Config) -> torch.optim.Adam:
    """One Adam group over every parameter (the reference's encoder/decoder
    split is inert).  The learning rate is set before each update."""
    return torch.optim.Adam(model.parameters(), lr=cfg.train.lr, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(cfg: Config, image_size: int, device, model: Optional[CoPoNeRF] = None) -> TrainState:
    """A fresh state: ``model`` or a seeded one (``cfg.train.seed``) on ``device``."""
    if model is None:
        model = init_weights(CoPoNeRF(cfg.model, image_size=image_size), seed=cfg.train.seed)
    model = model.to(device)
    return TrainState(model=model, optimizer=make_optimizer(model, cfg))


def learning_rate(cfg: Config, updates: int) -> float:
    """optax ``exponential_decay(staircase=True)`` over applied updates."""
    steps_per_epoch = max(cfg.train.steps_per_epoch or cfg.train.steps_til_summary, 1)
    return cfg.train.lr * cfg.train.lr_decay ** (updates // steps_per_epoch)


def attention_entropy(at_wt: torch.Tensor) -> torch.Tensor:
    ent = -(at_wt * torch.log(at_wt + 1e-5)).sum(dim=-1)
    return torch.nan_to_num(ent, nan=0.0).mean()


def _tensors(out):
    if torch.is_tensor(out):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)


@contextlib.contextmanager
def nan_checks(model: torch.nn.Module):
    """Raise ``FloatingPointError`` at the first module of ``model`` whose
    output holds a NaN (a forward hook on every module, innermost first),
    and through autograd's anomaly mode at the first backward operation
    that makes one.  For debugging: each check waits for the device."""
    def check(name, mod, args, out):
        for t in _tensors(out):
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {name or 'the model'} ({type(mod).__name__})")

    hooks = [m.register_forward_hook(lambda mod, args, out, name=name: check(name, mod, args, out))
             for name, m in model.named_modules()]
    try:
        with torch.autograd.set_detect_anomaly(True):
            yield
    finally:
        for h in hooks:
            h.remove()


def train_step(state: TrainState, batch: Dict[str, Any], cfg: Config,
               mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """One step on a batch of tensors on the model's device.  Returns the
    metrics as detached 0-d tensors: each loss, ``total_train_loss``,
    ``total_at_entropy`` and ``grad_norm`` (before clipping).  Under
    ``mesh`` the batch is this rank's share (``parallel.mesh.shard_batch``)
    of the global batch, every rank of the mesh takes the step together,
    and the metrics are the global batch's.  Under ``cfg.train.debug_nans``
    a NaN in the forward or the backward raises (``nan_checks``)."""
    model, opt = state.model, state.optimizer
    if mesh is not None:
        attach_batch_norm(model, mesh)
    with nan_checks(model) if cfg.train.debug_nans else contextlib.nullcontext():
        out = model(batch, val=False, train=True)
        losses, _ = lf_loss(cfg.loss, batch, out, batch["query"], mesh=mesh)
        total = sum(losses.values())
        opt.zero_grad(set_to_none=True)
        total.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if mesh is not None:
        average_gradients(mesh, grads)
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
    if finite:
        max_norm = cfg.train.clip_grad_norm
        if norm.item() >= max_norm:
            for g in grads:
                g.div_(norm).mul_(max_norm)
        for p in model.parameters():
            if p.grad is None:      # no loss reaches it: optax's zero gradient
                p.grad = torch.zeros_like(p)
        for group in opt.param_groups:
            group["lr"] = learning_rate(cfg, state.updates)
        opt.step()
        state.updates += 1
        state.notfinite_count = 0
    else:
        state.notfinite_count += 1
        state.total_notfinite += 1
    opt.zero_grad(set_to_none=True)
    state.step += 1
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["total_train_loss"] = total.detach()
    metrics["total_at_entropy"] = attention_entropy(out["at_wt"].detach())
    if mesh is not None:
        # equal shares: the global values are the ranks' averages
        averaged = average_over_world(mesh, torch.stack([v.float() for v in metrics.values()]))
        metrics = dict(zip(metrics, averaged.unbind()))
    metrics["grad_norm"] = norm.detach()
    return metrics


class MetricLogger:
    """Scalars to ``<logdir>/metrics.jsonl`` always; scalars and images to
    TensorBoard as well when ``torch.utils.tensorboard`` imports, else the
    images as ``<logdir>/images/<tag>_<step>.png``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._logdir = logdir
        self._f = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(logdir, flush_secs=10)
        except ImportError:
            pass

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        clean = {k: float(v) for k, v in metrics.items()}
        self._f.write(json.dumps({"step": step, **clean}) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(k, v, step)

    def log_image(self, step: int, tag: str, img) -> None:
        """An (H, W, 3) image in [0, 1]."""
        if self._tb is not None:
            self._tb.add_image(tag, img, step, dataformats="HWC")
            return
        from coponerf_tpu_torch.utils.png import write_png

        img_dir = os.path.join(self._logdir, "images")
        os.makedirs(img_dir, exist_ok=True)
        # TensorBoard's conversion of a float image: scale by 255, clip, truncate
        u8 = np.clip(np.asarray(img, np.float32) * 255.0, 0, 255).astype(np.uint8)
        write_png(os.path.join(img_dir, f"{tag}_{step:08d}.png"), u8)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def train(cfg: Config, batches: Iterable, num_steps: int, state: TrainState, device,
          log_every: int = 10, val_fn: Optional[Callable] = None, mesh: Optional[Mesh] = None) -> TrainState:
    """Run ``num_steps`` steps over ``batches`` (numpy batches in the
    ``data.synthetic.make_batch`` schema, cycled if exhausted), logging to
    ``<logging_root>/<experiment_name>/summaries`` and checkpointing to
    ``.../checkpoints`` at the JAX loop's cadences; returns the state.
    ``val_fn(state, step, logger)`` (``training/validation.py``) runs every
    ``steps_til_summary`` steps, after the rolling ``model_current``
    checkpoint.

    Under ``mesh`` every rank of the mesh calls ``train`` with its own
    ``batches``: its shares of the same global batches
    (``parallel.mesh.shard_batch``, or the loader's ``rank``/``world``).
    The model starts from rank 0's weights; rank 0 alone logs, checkpoints
    and validates, and the others wait for it on the group's store
    (``parallel.mesh.wait_for_rank0``, up to an hour) after each
    step where it does either, after its final checkpoint, and while it
    opens its logger."""
    lead = mesh is None or mesh.rank == 0

    def rank0_work_done() -> None:
        """Rank 0 says its own work is done; the others wait for that."""
        if mesh is not None and lead:
            rank0_done(mesh)
        elif mesh is not None:
            wait_for_rank0(mesh)

    logdir = os.path.join(cfg.logging_root, cfg.experiment_name)
    logger = MetricLogger(os.path.join(logdir, "summaries")) if lead else None   # TensorBoard imports for seconds
    rank0_work_done()
    if mesh is not None:
        replicate(mesh, state.model)
    ckpt_dir = os.path.join(logdir, "checkpoints")
    steps_per_epoch = cfg.train.steps_per_epoch or cfg.train.steps_til_summary
    it = iter(batches)
    t0 = time.time()
    try:
        for step in range(num_steps):
            try:
                batch_np = next(it)
            except StopIteration:
                it = iter(batches)
                batch_np = next(it)
            metrics = train_step(state, batch_to_torch(batch_np, device), cfg, mesh=mesh)
            iters = bool(cfg.train.iters_til_ckpt and step and step % cfg.train.iters_til_ckpt == 0)
            epoch = bool(cfg.train.epochs_til_ckpt and step
                         and step % (steps_per_epoch * cfg.train.epochs_til_ckpt) == 0)
            summary = bool(step and step % cfg.train.steps_til_summary == 0)
            if lead:
                if step % log_every == 0:
                    metrics["steps_per_sec"] = (step + 1) / (time.time() - t0)
                    logger.log(step, metrics)
                if iters:
                    ckpt_lib.save(ckpt_dir, state, step)
                if epoch:
                    ckpt_lib.save(ckpt_dir, state, step, name=f"model_epoch_{step // steps_per_epoch:04d}")
                if summary:
                    ckpt_lib.save(ckpt_dir, state, step, name="model_current")
                    if val_fn is not None:
                        val_fn(state, step, logger)
            if iters or epoch or summary:
                rank0_work_done()
        if lead:
            ckpt_lib.save(ckpt_dir, state, num_steps, name="model_final")
        rank0_work_done()
    finally:
        if logger is not None:
            logger.close()
    return state
