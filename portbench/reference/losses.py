"""Training losses of the reference: the always-on L1 image loss, the SSIM
loss on flow-warped context images under the cyclic-consistency masks, the
Huber cycle loss under its three masks and the pose loss (geodesic rotation
distance with ``eps=1e-7`` plus the translation L2), over one whole batch.
Images in the loss are NCHW.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from portbench.reference import flow as flow_ops
from portbench.reference.config import LossConfig
from portbench.reference.geometry import geodesic_rotation_distance


def gaussian_window(window_size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    xs = torch.arange(window_size, device=device) - window_size // 2
    g = torch.exp(-(xs.float() ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def _depthwise_conv2d(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """img (B, C, H, W); ``window`` (k, k) per channel, SAME padding."""
    c, k = img.shape[1], window.shape[0]
    return F.conv2d(img, window.expand(c, 1, k, k), padding=k // 2, groups=c)


def masked_ssim_loss(img1: torch.Tensor, img2: torch.Tensor, mask: torch.Tensor,
                     window_size: int = 11) -> torch.Tensor:
    """sum over the mask of (1 - SSIM) / sum(mask) / 3."""
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
    return torch.sum((1.0 - ssim_map) * mask) / torch.sum(mask) / 3.0


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
            gt: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The loss terms; the train step sums them."""
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
        s1 = masked_ssim_loss(w1, im0, mask_f[:, None].to(im0.dtype))
        s2 = masked_ssim_loss(w0, im1, mask_b[:, None].to(im0.dtype))
        losses["ssim_loss"] = cfg.w_ssim * (s1 + s2) / 2.0

    if cfg.cycle:
        pred = model_out["T_to_C1_pts"]
        targ = model_out["C2_pts_to_C1"]
        err = torch.linalg.vector_norm(pred - targ, dim=-1, keepdim=True)
        valid = err.detach() <= 20.0
        mask_c2 = model_out["mask_c2"][..., None]
        mask_cycle = model_out["matchability_cycle_mask"][..., None]
        m = valid.to(pred.dtype) * mask_c2.to(pred.dtype) * mask_cycle.to(pred.dtype)
        losses["cycle_loss"] = cfg.w_cycle * (torch.sum(huber(pred, targ) * m) / (torch.sum(m) + 1e-6))

    if cfg.pose:
        # eps keeps the arccos gradient finite as the pose converges
        rot = torch.mean(geodesic_rotation_distance(
            model_out["rel_pose"][:, :3, :3], model_out["gt_rel_pose"][:, :3, :3], eps=1e-7,
        ))
        trans = torch.mean(torch.linalg.vector_norm(
            model_out["rel_pose"][:, :3, 3] - model_out["gt_rel_pose"][:, :3, 3], dim=-1,
        ))
        losses["pose_loss"] = cfg.w_pose * (rot + trans)

    return losses
