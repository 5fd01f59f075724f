"""Offline evaluation harness: encode once per stereo pair, render the full
query image in ray chunks, compute quality and pose metrics binned by
overlap (replaces the reference's test.py:111-302).

The port's counterpart of ``coponerf_tpu/eval/harness.py``.  Chunks are a
Python loop of ``model.render(..., val=True)`` under ``torch.no_grad()`` on
the model's device; with ``ModelConfig(fast_sampling=True)`` each chunk
samples its latent levels through K8a (``ops.bilinear_sample``).

Deviations from the reference, by design (as in the JAX package):
  - equal-size ray chunks (plus one trailing partial chunk) instead of
    torch.chunk's 18 uneven chunks;
  - PSNR/SSIM recorded per batch element everywhere (the reference mixes a
    joint-over-batch PSNR into its 'all' bin, test.py:246).
With a ``logger`` (``training/trainer.py:MetricLogger``), ``evaluate``
writes each batch's image panels and pose scalars
(``training/summaries.py``), as the reference's test.py:270 does.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from coponerf_tpu_torch import trace
from coponerf_tpu_torch.eval import metrics as M
from coponerf_tpu_torch.models.coponerf import batch_to_torch

# per-ray render outputs assembled across chunks: key -> ray axis.  These are
# what the reference re-concatenates after its chunk loop (test.py:200-212,
# wrapper.py:188-219), including the real attention weights (at_wt) and the
# correspondence points and masks.
_RAY_AXIS = {
    "rgb": 2,
    "depth_ray": 1,
    "at_wt": 1,
    "T_to_C1_pts": 1,
    "T_to_C2_pts": 1,
    "C2_pts_to_C1": 1,
    "mask_c2": 1,
    "matchability_cycle_mask": 1,
}


def _chunk_query(batch, start: int, stop: int):
    q = dict(batch["query"])
    q["uv"] = batch["query"]["uv"][:, :, start:stop]
    q["rgb"] = batch["query"]["rgb"][:, :, start:stop]
    return {"context": batch["context"], "query": q}


def make_renderer(model, chunk: int = 4096, keys: tuple = ("rgb", "depth_ray", "at_wt"),
                  prune_invalid: bool = False):
    """Returns (encode, render_image) callables on ``model``'s device.

    ``encode(batch) -> SceneState``; ``render_image(batch, state, n_rays)``
    -> dict of per-ray outputs (``keys``, each a ``_RAY_AXIS`` entry)
    assembled across ``chunk``-ray renders, the last chunk partial.

    ``prune_invalid=True``: compute the per-ray epipolar validity first
    (``model.valid_ray_mask``), stably move the valid rays to the front and
    render only ceil(max_valid / chunk) chunks.  rgb of a pruned ray is the
    white the renderer would give it; the other outputs are zero there (the
    reference's values for such rays feed panels only, never metrics).
    ``render_image.last_n_rendered`` says how many rays were rendered."""

    @torch.no_grad()
    def encode(batch):
        return model.encode(batch, train=False)

    @torch.no_grad()
    def render_full(batch, state, n_rays: int) -> Dict[str, torch.Tensor]:
        parts = {k: [] for k in keys}
        for start in range(0, n_rays, chunk):
            out = model.render(_chunk_query(batch, start, min(start + chunk, n_rays)), state, val=True)
            for k in keys:
                parts[k].append(out[k])
        return {k: torch.cat(v, dim=_RAY_AXIS[k]) for k, v in parts.items()}

    @trace.spanned("render_image")
    def render_image(batch, state, n_rays: int) -> Dict[str, torch.Tensor]:
        render_image.last_n_rendered = n_rays
        if not prune_invalid:
            return render_full(batch, state, n_rays)
        mask = model.valid_ray_mask(batch, state, val=True).cpu().numpy()   # (B, n_rays) bool
        trace.count("host_syncs")
        n_valid = int(mask.sum(axis=-1).max())
        if n_valid >= n_rays:
            return render_full(batch, state, n_rays)
        # valid rays first; a stable sort keeps the image order inside each
        # class.  At least one chunk is rendered, so every key has a shape
        # even when no ray is valid (render() itself whitens invalid rays)
        order_np = np.argsort(~mask, axis=-1, kind="stable")
        order = torch.as_tensor(order_np, device=batch["query"]["uv"].device)
        trace.count("host_syncs")
        n_render = min(n_rays, max(chunk, -(-n_valid // chunk) * chunk))
        render_image.last_n_rendered = n_render
        q = dict(batch["query"])
        idx = order[:, None, :n_render, None]
        for k in ("uv", "rgb"):
            src = batch["query"][k]
            q[k] = torch.gather(src, 2, idx.expand(*src.shape[:2], n_render, src.shape[-1]))
        rendered = render_full({"context": batch["context"], "query": q}, state, n_render)
        return _scatter_back(rendered, torch.argsort(order, dim=-1), n_rays)

    render_image.last_n_rendered = 0
    return encode, render_image


def _scatter_back(rendered: Dict[str, torch.Tensor], inv: torch.Tensor, n_rays: int) -> Dict[str, torch.Tensor]:
    """Undo the valid-first order: pad each output from the rendered rays to
    ``n_rays`` with its fill (rgb white, the rest zero), then gather with
    the inverse permutation ``inv`` (B, n_rays), repeated per view row for
    the outputs with a (B*V) leading axis."""
    B = inv.shape[0]
    out = {}
    for k, v in rendered.items():
        ax = _RAY_AXIS[k]
        pad_shape = list(v.shape)
        pad_shape[ax] = n_rays - v.shape[ax]
        vp = torch.cat([v, torch.full(pad_shape, 1.0 if k == "rgb" else 0.0, dtype=v.dtype, device=v.device)],
                       dim=ax)
        if v.shape[0] % B:
            raise ValueError(f"{k}: leading axis {v.shape[0]} is not a multiple of the batch {B}")
        idx = inv.repeat_interleave(v.shape[0] // B, dim=0)
        ish = [1] * v.ndim
        ish[0], ish[ax] = idx.shape
        out[k] = torch.gather(vp, ax, idx.reshape(ish).expand(*vp.shape[:ax], n_rays, *vp.shape[ax + 1:]))
    return out


def evaluate(
    model,
    dataset,
    batch_size: int = 2,
    chunk: int = 4096,
    max_batches: Optional[int] = None,
    lpips_weights: Optional[str] = None,
    image_size: int = 256,
    verbose: bool = True,
    prune_invalid: bool = False,
    drop_last: bool = True,
    num_workers: int = 0,
    logger=None,
) -> M.MetricAccumulator:
    """Evaluate ``model`` (in eval mode, on its device) over ``dataset``'s
    items (batch, gt, overlap), as the JAX package's ``evaluate``.  LPIPS
    (with ``lpips_weights``) runs on the model's device.  ``logger``: each
    batch's panels and pose scalars under the prefix ``val_`` at step = the
    batch index.

    drop_last=True matches the reference protocol (its DataLoader drops the
    n % batch_size tail scenes, test.py:130); drop_last=False evaluates
    every scene.  num_workers>0 decodes scenes in spawned worker processes
    (``data.loader.PrefetchLoader``, in order).  ``rays_per_sec`` is timed
    from the encode to the rendered image on the host clock, after
    ``torch.cuda.synchronize()`` on a card."""
    from coponerf_tpu_torch.data.loader import PrefetchLoader

    if lpips_weights is None:
        # the reference protocol always reports LPIPS (test.py:258-263); a
        # run without it must not look like the full protocol
        warnings.warn(
            "LPIPS weights not provided: the LPIPS column will be MISSING and these results are NOT the "
            "full reference eval protocol (test.py:258-263)",
            stacklevel=2,
        )
    device = next(model.parameters()).device
    encode, render_image = make_renderer(model, chunk, prune_invalid=prune_invalid)
    acc = M.MetricAccumulator()

    loader = PrefetchLoader(dataset, batch_size, shuffle=False, num_workers=num_workers, drop_last=drop_last)
    n_batches = len(loader)
    if max_batches:
        n_batches = min(n_batches, max_batches)
    it = iter(loader)
    try:
        for bi in range(n_batches):
            batch_np, gt, overlaps = next(it)
            bs = batch_np["context"]["rgb"].shape[0]
            batch = batch_to_torch(batch_np, device)
            n_rays = batch["query"]["uv"].shape[2]

            t0 = time.time()
            state = encode(batch)
            rendered = render_image(batch, state, n_rays)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.time() - t0

            rgb = rendered["rgb"].float().cpu().numpy().reshape(bs, image_size, image_size, 3)
            target = np.asarray(gt["rgb"]).reshape(bs, image_size, image_size, 3)
            rgb = (np.clip(rgb, -1, 1) + 1) * 0.5
            target = (target + 1) * 0.5
            if lpips_weights is not None:
                lp_pred, lp_target = (torch.as_tensor(x * 2 - 1, dtype=torch.float32, device=device)
                                      for x in (rgb, target))

            rel_pose = state.rel_pose.float().cpu().numpy()
            ctx_c2w = np.asarray(batch_np["context"]["cam2world"])
            gt_rel = np.linalg.inv(ctx_c2w[:, 0]) @ ctx_c2w[:, 1]
            rot = M.rotation_geodesic(rel_pose[:, :3, :3], gt_rel[:, :3, :3])
            trans_l2, trans_ang = M.translation_error(rel_pose[:, :3, 3], gt_rel[:, :3, 3])

            for e in range(bs):
                vals = {
                    "psnr": M.psnr(rgb[e], target[e]),
                    "mse": float(np.mean((rgb[e] - target[e]) ** 2)),
                    "ssim": M.ssim(rgb[e], target[e]),
                    "rot": float(rot[e]),
                    "trans": float(trans_l2[e]),
                    "angle_trans": float(trans_ang[e]),
                    "rays_per_sec": n_rays * bs / dt,
                }
                if lpips_weights is not None:
                    vals["lpips"] = M.lpips_vgg(lp_pred[e], lp_target[e], lpips_weights)
                acc.add(M.overlap_bin(float(np.ravel(overlaps)[e])), **vals)
            if logger is not None:
                from coponerf_tpu_torch.training.summaries import img_summaries

                out = {"rgb": rgb * 2 - 1, "depth_ray": rendered["depth_ray"], "rel_pose": rel_pose,
                       "gt_rel_pose": gt_rel, "at_wt": rendered["at_wt"], "flow": state.flows}
                img_summaries(logger, batch_np, gt, out, bi, prefix="val_", img_shape=(image_size, image_size))
            if verbose:
                print(f"{bi + 1}/{n_batches} done.")
                print(acc.format())
    finally:
        it.close()  # stops loader workers even on early exit
    return acc
