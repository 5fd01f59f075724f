"""The conv_map table and its two epipolar samplings, with a direct
conv-kernel backward.

Counterpart of ``coponerf_tpu/ops/convmap_sample.py``.  Training samples the
256^2 conv_map table at ~12k points per view row; the table's own gradient
(B*V, 65536, 64) is only ever consumed by the conv's weight gradient, so the
backward skips it and sums the 7x7 input patches at the sample anchors
straight into the kernel gradient:

    dK = sum_n sum_corners w_c[n] * g[n] (x) rgb_patch7x7(pos_c[n])
    db = sum_n (sum_corners w_c[n]) * g[n]

It relies on two properties of ``grid_sample``: border padding clamps the
coordinates before the floor, so the 4 corners are always the (0|1, 0|1)
neighbours of the anchor; zeros padding zeroes the weights of corners off
the image, so a clamped anchor patch matters only where the weight is 0.

The gradient flows to the conv kernel and bias only: rgb is data and the
coordinates come from ground-truth poses.  The forward is the same conv and
the same two ``grid_sample`` calls as the unfused path; there is no Pallas
kernel in the JAX function, so the port's is plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from coponerf_tpu_torch.ops.bilinear_sample import bilinear_corner_decomposition
from coponerf_tpu_torch.ops.grid_sample import grid_sample


def _conv_table(rgb, weight, bias, conv_bf16: bool):
    """The ``ConvNHWC(3, C, 7, padding=3, dtype=bf16 or None)`` numerics:
    rgb (BV, H, W, 3), weight (C, 3, 7, 7) -> (BV, H, W, C)."""
    dt = torch.bfloat16 if conv_bf16 else torch.float32
    y = F.conv2d(rgb.to(dt).permute(0, 3, 1, 2), weight.to(dt), bias.to(dt), padding=weight.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def _swap_views(t: torch.Tensor) -> torch.Tensor:
    bv = t.shape[0]
    return t.reshape(bv // 2, 2, *t.shape[1:]).flip(1).reshape(t.shape)


def _grad_terms(col, grid, g, mode: str, patch_dtype):
    """dK (kh*kw*Cin, Cout) and db contributions of one sampled set.  col:
    (BV, H, W, kh*kw*Cin) im2col of the conv input, channel
    (dy*kw+dx)*Cin+ci at (y, x) holding input pixel (y-kh//2+dy, x-kw//2+dx,
    ci); grid (BV, P, 2); g (BV, P, Cout)."""
    BV, H, W, CK = col.shape
    Cout = g.shape[-1]
    idx, w = bilinear_corner_decomposition(grid, H, W, mode)          # (BV, P, 4)
    idx = idx.long()
    # anchor = corner 0 clamped to <= H-2 / W-2, so its 2x2 patch holds every
    # valid corner; per-corner offsets from it are exact in both modes
    ay = torch.clamp(idx[..., 0] // W, 0, H - 2)
    ax = torch.clamp(idx[..., 0] % W, 0, W - 2)
    sy = torch.clamp(idx // W - ay[..., None], 0, 1)
    sx = torch.clamp(idx % W - ax[..., None], 0, 1)
    rows = torch.arange(BV, device=col.device)[:, None]
    N = BV * grid.shape[1]
    g32 = g.reshape(N, Cout).float()
    w32 = w.reshape(N, 4)
    sy, sx = sy.reshape(N, 4), sx.reshape(N, 4)
    blend = torch.zeros((N, CK), dtype=torch.float32, device=col.device)
    for a in (0, 1):
        for b in (0, 1):
            w_ab = torch.sum(w32 * ((sy == a) & (sx == b)).float(), dim=-1)
            patch = col[rows, ay + a, ax + b].reshape(N, CK)
            blend = blend + w_ab[:, None] * patch.float()
    # products of patch-dtype values, summed in f32
    dk = blend.to(patch_dtype).float().t() @ g32.to(patch_dtype).float()
    db = torch.einsum("n,nc->c", w32.sum(dim=-1), g32)
    return dk, db


class _ConvmapSamplePair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rgb, weight, bias, grid_p, grid_s, conv_bf16, sample_bf16):
        table = _conv_table(rgb, weight, bias, conv_bf16)
        if sample_bf16:
            table = table.to(torch.bfloat16)
        s_p = grid_sample(table, grid_p, "border")
        s_s = grid_sample(_swap_views(table), grid_s, "zeros")
        ctx.save_for_backward(rgb, grid_p, grid_s)
        ctx.meta = (weight.shape, weight.dtype, bias.dtype, conv_bf16 or sample_bf16)
        return s_p, s_s

    @staticmethod
    def backward(ctx, g_p, g_s):
        rgb, grid_p, grid_s = ctx.saved_tensors
        (cout, cin, kh, kw), w_dtype, b_dtype, low = ctx.meta
        patch_dtype = torch.bfloat16 if low else torch.float32
        BV, H, W, _ = rgb.shape
        rgbp = F.pad(rgb.to(patch_dtype), (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
        col = torch.cat([rgbp[:, dy: dy + H, dx: dx + W, :] for dy in range(kh) for dx in range(kw)], dim=-1)
        dk_p, db_p = _grad_terms(col, grid_p, g_p, "border", patch_dtype)
        # the secondary set sampled the view-swapped table: the full sum over
        # rows is the same with grids and cotangents swapped back
        dk_s, db_s = _grad_terms(col, _swap_views(grid_s), _swap_views(g_s), "zeros", patch_dtype)
        dk, db = dk_p + dk_s, db_p + db_s
        dweight = dk.reshape(kh, kw, cin, cout).permute(3, 2, 0, 1).to(w_dtype)
        return None, dweight, db.to(b_dtype), None, None, None, None


def convmap_sample_pair(rgb, weight, bias, grid_p, grid_s, conv_bf16: bool, sample_bf16: bool):
    """rgb (B*V, H, W, 3) normalized input (view pairs in adjacent rows);
    ``weight`` (C, 3, kh, kw) and ``bias`` (C,) of the conv_map layer;
    grid_p / grid_s (B*V, P, 2) in [-1, 1].  Returns (primary, secondary)
    samples (B*V, P, C):
      primary   = grid_sample(conv(rgb), grid_p, border)
      secondary = grid_sample(swap_views(conv(rgb)), grid_s, zeros)"""
    return _ConvmapSamplePair.apply(rgb, weight, bias, grid_p, grid_s, conv_bf16, sample_bf16)
