"""Optical-flow utilities that encode(), render() and the SSIM loss use:
warping, cyclic-consistency masks, and keypoint transfer through flow
fields.

Counterpart of the matching functions of ``coponerf_tpu/flow.py``.  Flow
tensors are NCHW (B, 2, H, W), channel 0 = x-flow, 1 = y-flow, in pixels.
"""

from __future__ import annotations

import torch

from coponerf_tpu_torch.ops.grid_sample import grid_sample_dense_nchw
from coponerf_tpu_torch.ops.resize import resize_nchw

_I32_MIN = -2147483648.0
_I32_MAX = 2147483520.0  # largest float32 below 2**31


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """Float -> int32 with XLA's conversion semantics: truncate toward zero,
    NaN -> 0, saturate out-of-range values (torch's own cast leaves those
    undefined)."""
    x = torch.nan_to_num(x, nan=0.0).clamp(_I32_MIN, _I32_MAX)
    return torch.trunc(x).to(torch.int32)


def warp(x: torch.Tensor, flo: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``x`` (B, C, H, W) by ``flo`` (B, 2, H, W): bilinear,
    zero padding, align_corners=False."""
    _, _, h, w = x.shape
    xx = torch.arange(w, dtype=flo.dtype, device=flo.device)[None, None, :]
    yy = torch.arange(h, dtype=flo.dtype, device=flo.device)[None, :, None]
    vx = (xx + flo[:, 0]) * 2.0 / max(w - 1, 1) - 1.0
    vy = (yy + flo[:, 1]) * 2.0 / max(h - 1, 1) - 1.0
    return grid_sample_dense_nchw(x, torch.stack([vx, vy], dim=-1))


def convert_flow_to_mapping(flow: torch.Tensor) -> torch.Tensor:
    """Pixel flow (B, 2, H, W) -> absolute pixel mapping (B, 2, H, W)."""
    _, _, h, w = flow.shape
    xx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, None, :]
    yy = torch.arange(h, dtype=flow.dtype, device=flow.device)[None, :, None]
    return torch.stack([flow[:, 0] + xx, flow[:, 1] + yy], dim=1)


def get_gt_correspondence_mask(flow: torch.Tensor) -> torch.Tensor:
    """Mask of flows that land inside the image: (B, 2, H, W) -> (B, H, W)."""
    mapping = convert_flow_to_mapping(flow)
    _, _, h, w = mapping.shape
    mask_x = (mapping[:, 0] >= 0) & (mapping[:, 0] <= w - 1)
    mask_y = (mapping[:, 1] >= 0) & (mapping[:, 1] <= h - 1)
    return mask_x & mask_y


def cyclic_consistency_masks(flow_fwd, flow_bwd, out_size: int = 256, threshold: float = 10.0, scale: float | None = None):
    """Upsample both flows to ``out_size`` (values times ``scale``, default
    out_size / flow_h) and return (up_fwd, up_bwd, mask_fwd, mask_bwd)."""
    h = flow_fwd.shape[-2]
    if scale is None:
        scale = out_size / h
    up_fwd = resize_nchw(flow_fwd, (out_size, out_size), align_corners=False) * scale
    up_bwd = resize_nchw(flow_bwd, (out_size, out_size), align_corners=False) * scale
    err_fwd = torch.linalg.vector_norm(up_fwd + warp(up_bwd, up_fwd), dim=1) <= threshold
    err_bwd = torch.linalg.vector_norm(up_bwd + warp(up_fwd, up_bwd), dim=1) <= threshold
    mask_fwd = err_fwd & get_gt_correspondence_mask(up_fwd)
    mask_bwd = err_bwd & get_gt_correspondence_mask(up_bwd)
    return up_fwd, up_bwd, mask_fwd, mask_bwd


def ssim_warp_packed(im0, im1, flow_fwd, flow_bwd, out_size: int = 256, threshold: float = 10.0,
                     scale: float | None = None):
    """The SSIM loss's warps: each context image and the other direction's
    upsampled flow packed into one 5-channel warp per direction (they share
    the warp grid).  Returns (warped_im1, warped_im0, mask_fwd, mask_bwd),
    equal to ``cyclic_consistency_masks`` plus two separate ``warp`` calls.
    The packed flow channels are detached, as the JAX package stops their
    gradient: they feed only the boolean consistency test.  The warp grid
    keeps its gradient, so this goes through ``grid_sample_dense_nchw``,
    never a table-only-gradient sampler."""
    h = flow_fwd.shape[-2]
    if scale is None:
        scale = out_size / h
    up_fwd = resize_nchw(flow_fwd, (out_size, out_size), align_corners=False) * scale
    up_bwd = resize_nchw(flow_bwd, (out_size, out_size), align_corners=False) * scale
    pf = warp(torch.cat([im1, up_bwd.detach()], dim=1), up_fwd)
    pb = warp(torch.cat([im0, up_fwd.detach()], dim=1), up_bwd)
    c_im = im0.shape[1]
    warped_im1, warped_bwd = pf[:, :c_im], pf[:, c_im:]
    warped_im0, warped_fwd = pb[:, :c_im], pb[:, c_im:]
    err_fwd = torch.linalg.vector_norm(up_fwd + warped_bwd, dim=1) <= threshold
    err_bwd = torch.linalg.vector_norm(up_bwd + warped_fwd, dim=1) <= threshold
    mask_fwd = err_fwd & get_gt_correspondence_mask(up_fwd)
    mask_bwd = err_bwd & get_gt_correspondence_mask(up_bwd)
    return warped_im1, warped_im0, mask_fwd, mask_bwd


def flow2kps_from_upsampled(trg_kps: torch.Tensor, up: torch.Tensor, n_pts: int):
    """Transfer keypoints (B, N, 2) through an upsampled, scaled flow
    (B, 2, H, W).  Returns (src_kps (B, 2, n_pts), in-bounds mask (B, n_pts))."""
    hw = up.shape[-2:]
    kps_i = to_int32(trg_kps[:, :n_pts])
    mask = ((kps_i >= 0) & (kps_i < hw[0])).all(dim=-1)
    kp = torch.clamp(kps_i, 0, hw[0] - 1).long()
    flat = up.reshape(up.shape[0], 2, -1)
    idx = kp[..., 1] * hw[1] + kp[..., 0]
    sampled = torch.gather(flat, 2, idx[:, None, :].expand(-1, 2, -1))
    src_kps = kp.transpose(1, 2).to(up.dtype) + sampled
    return src_kps, mask


def mask_from_confidence(points: torch.Tensor, confidence: torch.Tensor, n_pts: int, upsample_size: tuple[int, int] = (256, 256)) -> torch.Tensor:
    """Sample a confidence map (B, H, W) at clamped integer pixel locations
    of ``points`` (B, N, 2) -> (B, n_pts)."""
    kp = torch.clamp(to_int32(points[:, :n_pts]), 0, upsample_size[0] - 1).long()
    flat = confidence.reshape(confidence.shape[0], -1)
    idx = kp[..., 1] * upsample_size[1] + kp[..., 0]
    return torch.gather(flat, 1, idx)
