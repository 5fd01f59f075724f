"""Image and scalar summaries of training validation and evaluation.

The port of ``coponerf_tpu/training/summaries.py`` (reference:
summary/summaries.py:106-267 and summary/inspect_epipolar_geometry.py:13-122):
prediction, depth, context and query panels, flow-warped context panels
with cyclic-consistency overlays, epipolar-line panels under the estimated
and the ground-truth relative pose, the attention entropy and the pose
errors, with the JAX package's tags and scalars.  They go through a
``MetricLogger`` (``training/trainer.py``).

The drawing is numpy, so it needs neither cv2 nor matplotlib: filled
circles and 10-px lines as distance masks (cv2.circle / cv2.line), the
0.4 / 0.6 blend of cv2.addWeighted, the mask outline of cv2.findContours +
cv2.drawContours as the mask's 4-neighbour boundary, and matplotlib's
``jet`` as its 256-entry table.  The warped panels use the port's own
``flow.cyclic_consistency_masks`` and ``flow.warp`` on the CPU, in f32.
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple

import numpy as np

# matplotlib's jet (_cm.py): per channel, (x, y) breakpoints of a piecewise
# linear ramp, sampled into a 256-entry table as matplotlib samples it
_JET = {
    "red": ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    "green": ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0), (1.0, 0.0)),
    "blue": ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
}
_JET_LUT = np.stack([np.interp(np.linspace(0.0, 1.0, 256), *np.array(_JET[c]).T)
                     for c in ("red", "green", "blue")], axis=-1)


def jet(x: np.ndarray) -> np.ndarray:
    """matplotlib ``get_cmap("jet")(x)[..., :3]`` for x in [0, 1]: the
    table entry ``int(x * 256)`` (1.0 takes the last); NaN maps to black."""
    x = np.asarray(x, np.float64)
    bad = ~np.isfinite(x)
    idx = np.clip((np.where(bad, 0.0, x) * 256).astype(np.int64), 0, 255)
    out = _JET_LUT[idx]
    out[bad] = 0.0
    return out


def _np(x) -> np.ndarray:
    """A tensor (any device, any float dtype) or array -> a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def _skew(t: np.ndarray) -> np.ndarray:
    return np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])


def fundamental_from_pose(K1: np.ndarray, K2: np.ndarray, rel_pose: np.ndarray) -> np.ndarray:
    """F = K2^-T [t]x R K1^-1 per batch element."""
    R = rel_pose[:, :3, :3]
    T = rel_pose[:, :3, 3]
    Fs = []
    for i in range(len(T)):
        E = _skew(T[i]) @ R[i]
        Fs.append(np.linalg.inv(K2[i, :3, :3]).T @ E @ np.linalg.inv(K1[i, :3, :3]))
    return np.stack(Fs)


_PTS = np.array([[64, 64], [64, 128], [64, 192], [128, 64], [128, 128], [128, 192], [192, 64], [192, 128],
                 [192, 192]])
_COLORS = np.array(
    [[63, 228, 92], [222, 155, 167], [56, 220, 130], [216, 43, 206], [47, 172, 72],
     [198, 181, 0], [137, 99, 246], [22, 160, 10], [23, 240, 252]]
)


def epipolar_lines(F: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """cv2.computeCorrespondEpilines(pts, 1, F): the lines a x + b y + c = 0
    in the second image of points of the first, scaled to a^2 + b^2 = 1,
    as (n, 3) float32."""
    pts = np.asarray(pts, np.float32).astype(np.float64)
    lines = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ np.asarray(F, np.float64).T
    norm = np.hypot(lines[:, 0], lines[:, 1])
    return (lines / np.where(norm > 0, norm, 1.0)[:, None]).astype(np.float32)


def _pixel_grid(h: int, w: int):
    ys, xs = np.mgrid[0:h, 0:w]
    return xs.astype(np.float64), ys.astype(np.float64)


def _disc_mask(h: int, w: int, center, radius: float) -> np.ndarray:
    xs, ys = _pixel_grid(h, w)
    return (xs - center[0]) ** 2 + (ys - center[1]) ** 2 <= radius ** 2


def _segment_mask(h: int, w: int, p0, p1, thickness: int) -> np.ndarray:
    """Pixels whose centre lies within (thickness + 1) / 2 of the segment
    p0-p1: a thick line with round caps, as cv2.line rasterises it."""
    xs, ys = _pixel_grid(h, w)
    p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    d = p1 - p0
    t = np.clip(((xs - p0[0]) * d[0] + (ys - p0[1]) * d[1]) / max(float(d @ d), 1e-12), 0.0, 1.0)
    return (xs - p0[0] - t * d[0]) ** 2 + (ys - p0[1] - t * d[1]) ** 2 <= (thickness / 2.0 + 0.5) ** 2


def _blend(a: np.ndarray, alpha: float, b: np.ndarray, beta: float) -> np.ndarray:
    """cv2.addWeighted(a, alpha, b, beta, 0) on uint8: rounded, saturated."""
    v = a.astype(np.float32) * np.float32(alpha) + b.astype(np.float32) * np.float32(beta)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def epipolar_panels(img1, K1, img2, K2, rel_pose_est, rel_pose_gt) -> Tuple[np.ndarray, np.ndarray]:
    """Epipolar lines of nine fixed keypoints of img1, drawn in img2 under
    the estimated and the ground-truth fundamental matrix: two (B, H, 2W, 3)
    uint8 stacks, each row [img1 with the keypoints | img2 blended 0.4 / 0.6
    with its lines].  imgs: (B, H, W, 3) in [-1, 1]."""
    F_est = fundamental_from_pose(K1, K2, rel_pose_est)
    F_gt = fundamental_from_pose(K1, K2, rel_pose_gt)
    pred_panels, gt_panels = [], []
    for i in range(len(F_est)):
        left = ((img1[i] + 1) * 127.5).astype(np.uint8)
        h1, w1 = left.shape[:2]
        for p, c in zip(_PTS, _COLORS):
            left[_disc_mask(h1, w1, p, 5)] = c
        for F, out in ((F_est[i], pred_panels), (F_gt[i], gt_panels)):
            right = ((img2[i] + 1) * 127.5).astype(np.uint8)
            overlay = right.copy()
            h, w = right.shape[:2]
            for l, c in zip(epipolar_lines(F, _PTS), _COLORS):
                if abs(l[1]) < 1e-9:
                    continue
                y0, y1 = int(-l[2] / l[1]), int(-(l[2] + l[0] * w) / l[1])
                overlay[_segment_mask(h, w, (0, y0), (w, y1), 10)] = c
            out.append(np.concatenate([left, _blend(overlay, 0.4, right, 0.6)], axis=1))
    return np.stack(pred_panels), np.stack(gt_panels)


def _grid(images: np.ndarray) -> np.ndarray:
    """(N, H, W, 3) in [-1, 1] -> one row strip in [0, 1]."""
    images = (np.clip(images, -1, 1) + 1) * 0.5
    return np.concatenate(list(images), axis=1)


def mask_boundary(mask: np.ndarray) -> np.ndarray:
    """Pixels of ``mask`` with a 4-neighbour outside it, the image's outside
    counting as outside: the outline cv2.findContours traces."""
    m = np.pad(mask.astype(bool), 1)
    inner = m[1:-1, 1:-1] & m[:-2, 1:-1] & m[2:, 1:-1] & m[1:-1, :-2] & m[1:-1, 2:]
    return mask.astype(bool) & ~inner


def _overlay_mask(img_u8: np.ndarray, invalid: np.ndarray, color=(255, 102, 51), alpha=0.5) -> np.ndarray:
    """Blend ``color`` over the pixels where ``invalid`` (H, W) holds and
    outline them in ``color``: the reference's overlay_semantic_mask
    (summary/summaries.py:42-72) for the cyclic-consistency overlays."""
    out = img_u8.copy()
    c = np.array(color, np.float32)
    sel = invalid.astype(bool)
    out[sel] = (out[sel] * alpha + c * (1 - alpha)).astype(np.uint8)
    out[mask_boundary(sel)] = np.array(color, np.uint8)
    return out


def warped_context_panels(ctx_rgb: np.ndarray, flow_fwd, flow_bwd) -> Dict[str, np.ndarray]:
    """Flow-warped context panels with cyclic-consistency overlays
    (reference summary/summaries.py:163-207).

    ctx_rgb: (B, 2, H, W, 3) in [-1, 1]; flows: (B, 2, h, w) NCHW pixels
    (arrays or tensors).  Returns 4 panels, each (B, 3H, W, 3) in [0, 1]:
    ``warped_img`` = [ctx2 ; warp(ctx2, up_fwd) ; ctx1] stacked on H, the
    same with the invalid-mask overlay (``masked_warped_img``) and the
    reverse direction (``_flip``)."""
    import torch

    from coponerf_tpu_torch import flow as flow_ops

    B, _, H, W, _ = ctx_rgb.shape
    f_fwd = torch.from_numpy(np.ascontiguousarray(_np(flow_fwd), np.float32))
    f_bwd = torch.from_numpy(np.ascontiguousarray(_np(flow_bwd), np.float32))
    rgb = torch.from_numpy(np.ascontiguousarray(ctx_rgb, np.float32))
    with torch.no_grad():
        up_f, up_b, mask_f, mask_b = flow_ops.cyclic_consistency_masks(
            f_fwd, f_bwd, out_size=H, threshold=10.0, scale=H / f_fwd.shape[-2])
        im1 = rgb[:, 0].permute(0, 3, 1, 2)
        im2 = rgb[:, 1].permute(0, 3, 1, 2)
        w_f = flow_ops.warp((im2 + 1.0) * 0.5, up_f).permute(0, 2, 3, 1).numpy()   # ctx2 toward ctx1
        w_b = flow_ops.warp((im1 + 1.0) * 0.5, up_b).permute(0, 2, 3, 1).numpy()
    mask_f, mask_b = mask_f.numpy(), mask_b.numpy()
    ctx01 = (np.clip(ctx_rgb, -1, 1) + 1) * 0.5

    panels = {"warped_img": [], "masked_warped_img": [], "warped_img_flip": [], "masked_warped_img_flip": []}
    for i in range(B):
        over_f = _overlay_mask((np.clip(w_f[i], 0, 1) * 255).astype(np.uint8), ~mask_f[i])
        over_b = _overlay_mask((np.clip(w_b[i], 0, 1) * 255).astype(np.uint8), ~mask_b[i])
        panels["warped_img"].append(np.concatenate([ctx01[i, 1], w_f[i], ctx01[i, 0]], axis=0))
        panels["masked_warped_img"].append(np.concatenate([ctx01[i, 1], over_f / 255.0, ctx01[i, 0]], axis=0))
        panels["warped_img_flip"].append(np.concatenate([ctx01[i, 0], w_b[i], ctx01[i, 1]], axis=0))
        panels["masked_warped_img_flip"].append(np.concatenate([ctx01[i, 0], over_b / 255.0, ctx01[i, 1]], axis=0))
    return {k: np.clip(np.stack(v), 0.0, 1.0) for k, v in panels.items()}


def img_summaries(logger, model_input: Dict, gt: Dict, model_output: Dict, step: int, prefix: str = "",
                  img_shape: Tuple[int, int] = (256, 256)) -> None:
    """Log the panels and scalars of one batch.  ``model_output`` holds
    ``rgb``, ``depth_ray``, ``at_wt``, ``rel_pose``, ``gt_rel_pose`` and
    optionally ``flow``; arrays or tensors on any device."""
    h, w = img_shape
    pred = _np(model_output["rgb"]).reshape(-1, h, w, 3)
    logger.log_image(step, prefix + "predictions", _grid(pred))

    depth = _np(model_output["depth_ray"]).reshape(-1, h, w) / 10.0
    logger.log_image(step, prefix + "depth_images", np.concatenate(list(jet(np.clip(depth, 0, 1))), axis=1))

    ctx = _np(model_input["context"]["rgb"])
    logger.log_image(step, prefix + "context_images", _grid(ctx.reshape(-1, *ctx.shape[2:])))
    qry = _np(gt["rgb"]).reshape(-1, h, w, 3)
    logger.log_image(step, prefix + "query_images", _grid(qry))

    # flow-warped context panels with cyclic-consistency overlays
    # (reference summary/summaries.py:163-207): observability, so a failure
    # warns and the run goes on
    if "flow" in model_output:
        try:
            flows = model_output["flow"]
            for k, v in warped_context_panels(ctx, flows[0], flows[1]).items():
                logger.log_image(step, prefix + k, np.concatenate(list(v), axis=1))
        except Exception as e:
            warnings.warn(f"warped context panels skipped: {type(e).__name__}: {e}", stacklevel=2)

    rel_pose = _np(model_output["rel_pose"])
    gt_rel = _np(model_output["gt_rel_pose"])
    intr = _np(model_input["context"]["intrinsics"])
    pred_panels, gt_panels = epipolar_panels(ctx[:, 1], intr[:, 1], ctx[:, 0], intr[:, 0], rel_pose, gt_rel)
    logger.log_image(step, prefix + "epipolar_pred", pred_panels[0] / 255.0)
    logger.log_image(step, prefix + "epipolar_GT", gt_panels[0] / 255.0)

    # scalars (summaries.py:114-121, 225-232)
    at_wt = _np(model_output["at_wt"])
    ent = -(at_wt * np.log(at_wt + 1e-5)).sum(-1)
    m = rel_pose[:, :3, :3] @ np.swapaxes(gt_rel[:, :3, :3], -1, -2)
    cos = np.clip((m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2] - 1) / 2, -1, 1)
    deg = np.degrees(np.arccos(cos))
    logger.log(step, {
        prefix + "ent": float(np.nan_to_num(ent).mean()),
        prefix + "rot_distance": float(np.arccos(cos).mean()),
        prefix + "rot_distance_degrees_mean": float(deg.mean()),
        prefix + "rot_distance_degrees_std": float(deg.std()),
        prefix + "rot_distance_degrees_max": float(deg.max()),
        prefix + "tran_L1": float(np.mean((rel_pose[:, :3, 3] - gt_rel[:, :3, 3]) ** 2)),
        prefix + "out_min": float(pred.min()),
        prefix + "out_max": float(pred.max()),
    })
