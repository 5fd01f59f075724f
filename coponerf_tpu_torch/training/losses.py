"""Training losses.

Counterpart of ``coponerf_tpu/training/losses.py``: the always-on L1 image
loss, the SSIM loss on flow-warped context images under the
cyclic-consistency masks, the Huber cycle loss under its three masks and
the pose loss (geodesic rotation distance with ``eps=1e-7`` plus the
translation L2).  Images in the loss are NCHW, as in the JAX package.

Under a mesh (``parallel/mesh.py``) each rank holds an equal share of the
global batch, and the train step averages the ranks' losses and gradients.
The plain means then average to the global batch's.  The two masked means
(SSIM, cycle) divide by the GLOBAL mask sum (an all-reduce of the detached
sums: the masks carry no gradient) and are scaled by the number of ranks
that sum, so that the average over the ranks is the global batch's masked
mean, as in the JAX package's step on the global batch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from coponerf_tpu_torch import flow as flow_ops
from coponerf_tpu_torch.config import LossConfig
from coponerf_tpu_torch.geometry import geodesic_rotation_distance
from coponerf_tpu_torch.parallel.mesh import Mesh, group_size


def gaussian_window(window_size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    xs = torch.arange(window_size, device=device) - window_size // 2
    g = torch.exp(-(xs.float() ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def _depthwise_conv2d(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """img (B, C, H, W); ``window`` (k, k) per channel, SAME padding."""
    c, k = img.shape[1], window.shape[0]
    return F.conv2d(img, window.expand(c, 1, k, k), padding=k // 2, groups=c)


def global_sum(x: torch.Tensor, group) -> Tuple[torch.Tensor, int]:
    """(the detached ``x`` summed over ``group``, the number of ranks in it)."""
    x = x.detach()
    if group is None:
        return x, 1
    x = x.clone()
    torch.distributed.all_reduce(x, group=group)
    return x, group_size(group)


def masked_ssim_loss(img1: torch.Tensor, img2: torch.Tensor, mask: torch.Tensor, window_size: int = 11,
                     group=None) -> torch.Tensor:
    """sum over the mask of (1 - SSIM) / sum(mask) / 3 (the reference's
    normalisation); with a process ``group``, sum(mask) over its ranks,
    the result scaled by their number."""
    win = gaussian_window(window_size, device=img1.device)
    mu1 = _depthwise_conv2d(img1, win)
    mu2 = _depthwise_conv2d(img2, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _depthwise_conv2d(img1 * img1, win) - mu1_sq
    sigma2_sq = _depthwise_conv2d(img2 * img2, win) - mu2_sq
    sigma12 = _depthwise_conv2d(img1 * img2, win) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    if group is None:
        return torch.sum((1.0 - ssim_map) * mask) / torch.sum(mask) / 3.0
    den, n = global_sum(torch.sum(mask), group)
    return torch.sum((1.0 - ssim_map) * mask) / den / 3.0 * n


def image_loss(model_out: Dict[str, Any], gt: Dict[str, Any]) -> torch.Tensor:
    gt_rgb = torch.nan_to_num(gt["rgb"], nan=0.0)
    rgb = torch.nan_to_num(model_out["rgb"], nan=0.0)
    return torch.mean(torch.abs(gt_rgb - rgb))


def huber(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """``F.huber_loss(reduction='none')`` in the JAX package's form."""
    err = pred - target
    abs_err = torch.abs(err)
    return torch.where(abs_err < delta, 0.5 * err ** 2, delta * (abs_err - 0.5 * delta))


def lf_loss(cfg: LossConfig, model_input: Dict[str, Any], model_out: Dict[str, Any],
            gt: Dict[str, Any], mesh: Optional[Mesh] = None) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Returns (loss_dict, aux); the train step sums the loss_dict's scalars.
    Under ``mesh`` these are this rank's terms, whose average over the ranks
    is the global batch's loss (see the module docstring)."""
    losses: Dict[str, torch.Tensor] = {"img_loss": image_loss(model_out, gt)}

    if cfg.ssim:
        flow_f, flow_b = model_out["flow"][0], model_out["flow"][1]
        h = flow_f.shape[-2]
        ctx_rgb = model_input["context"]["rgb"]
        out_size = ctx_rgb.shape[2]
        im0 = ctx_rgb[:, 0].permute(0, 3, 1, 2)
        im1 = ctx_rgb[:, 1].permute(0, 3, 1, 2)
        w1, w0, mask_f, mask_b = flow_ops.ssim_warp_packed(
            im0, im1, flow_f, flow_b, out_size=out_size, scale=out_size / h
        )
        # the context images are cut along data only: the mask sums over the data group
        group = None if mesh is None else mesh.group("data")
        s1 = masked_ssim_loss(w1, im0, mask_f[:, None].to(im0.dtype), group=group)
        s2 = masked_ssim_loss(w0, im1, mask_b[:, None].to(im0.dtype), group=group)
        losses["ssim_loss"] = cfg.w_ssim * (s1 + s2) / 2.0

    if cfg.cycle:
        pred = model_out["T_to_C1_pts"]
        targ = model_out["C2_pts_to_C1"]
        err = torch.linalg.vector_norm(pred - targ, dim=-1, keepdim=True)
        valid = err.detach() <= 20.0
        mask_c2 = model_out["mask_c2"][..., None]
        mask_cycle = model_out["matchability_cycle_mask"][..., None]
        m = valid.to(pred.dtype) * mask_c2.to(pred.dtype) * mask_cycle.to(pred.dtype)
        if mesh is None:
            losses["cycle_loss"] = cfg.w_cycle * (torch.sum(huber(pred, targ) * m) / (torch.sum(m) + 1e-6))
        else:
            # the rays are cut along data and rays: the mask sums over every rank
            den, n = global_sum(torch.sum(m), torch.distributed.group.WORLD)
            losses["cycle_loss"] = cfg.w_cycle * (torch.sum(huber(pred, targ) * m) / (den + 1e-6) * n)

    if cfg.pose:
        # eps keeps the arccos gradient finite as the pose converges
        rot = torch.mean(geodesic_rotation_distance(
            model_out["rel_pose"][:, :3, :3], model_out["gt_rel_pose"][:, :3, :3], eps=1e-7,
        ))
        trans = torch.mean(torch.linalg.vector_norm(
            model_out["rel_pose"][:, :3, 3] - model_out["gt_rel_pose"][:, :3, 3], dim=-1,
        ))
        losses["pose_loss"] = cfg.w_pose * (rot + trans)

    return losses, {}
