"""In-training validation: each validation pair's full image rendered in ray
chunks, the enabled losses on the assembled outputs, and image summaries
(replaces wrapper.py:160-254, without the reference's bare-except swallow).

The port of ``coponerf_tpu/training/validation.py``.  The model runs under
``torch.no_grad()`` in ``eval()`` mode (BatchNorm on its running
statistics, as the JAX package's val render) and goes back to ``train()``
afterwards.  The render is the evaluation harness's chunked render
(``eval/harness.py:make_renderer``): under the fast config K8a, K2 and K3.
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterable

import numpy as np
import torch

from coponerf_tpu_torch.config import Config
from coponerf_tpu_torch.eval.harness import make_renderer
from coponerf_tpu_torch.models.coponerf import batch_to_torch
from coponerf_tpu_torch.training import summaries as S
from coponerf_tpu_torch.training.losses import lf_loss


def make_val_fn(cfg: Config, val_batches: Iterable, chunk: int = 512, image_size: int = 256,
                max_batches: int = 8) -> Callable:
    """Returns ``val_fn(state, step, logger)`` for ``trainer.train``.

    ``val_batches``: (model_input, gt) numpy batches with full query images
    (uv covers the image); at most ``max_batches`` are kept, a periodic
    spot check as the reference's.  ``val_fn`` logs ``val_<term>``, each
    loss term's mean over the batches, then the summaries of the last batch
    under the prefix ``val_``."""
    # every per-ray output the enabled losses and summaries need: the real
    # at_wt, and the correspondence points and masks of the cycle loss
    keys = ("rgb", "depth_ray", "at_wt")
    if cfg.loss.cycle:
        keys += ("T_to_C1_pts", "C2_pts_to_C1", "mask_c2", "matchability_cycle_mask")
    batches = list(itertools.islice(iter(val_batches), max_batches))

    def val_fn(state, step: int, logger) -> None:
        model = state.model
        device = next(model.parameters()).device
        encode, render_image = make_renderer(model, chunk, keys=keys)
        was_training = model.training
        model.eval()
        try:
            losses_acc = {}
            last = None
            with torch.no_grad():
                for batch_np, gt in batches:
                    batch = batch_to_torch(batch_np, device)
                    scene = encode(batch)
                    out = dict(render_image(batch, scene, batch["query"]["uv"].shape[2]))
                    c2w = batch["context"]["cam2world"]
                    out.update(flow=scene.flows, rel_pose=scene.rel_pose,
                               gt_rel_pose=torch.linalg.inv(c2w[:, 0]) @ c2w[:, 1])
                    # every enabled term on the assembled outputs: ssim needs
                    # only the pair's flows, cycle the assembled points
                    val_losses, _ = lf_loss(cfg.loss, batch, out, batch_to_torch(gt, device))
                    for k, v in val_losses.items():
                        losses_acc.setdefault(k, []).append(float(v))
                    last = (batch_np, gt, out)
        finally:
            model.train(was_training)
        logger.log(step, {f"val_{k}": float(np.mean(v)) for k, v in losses_acc.items()})
        if last is not None:
            batch_np, gt, out = last
            S.img_summaries(logger, batch_np, gt, out, step, prefix="val_", img_shape=(image_size, image_size))

    return val_fn
