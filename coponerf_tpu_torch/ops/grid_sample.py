"""Exact bilinear image sampling at irregular coordinates (f32 gather).

Counterpart of ``coponerf_tpu/ops/grid_sample.py``: ``border`` and ``zeros``
padding under ``align_corners=False``, with the same unnormalization, the
same ``_EDGE_EPS`` border clamp and the same ``_COORD_CLIP`` NaN/Inf scrub.
Zeros mode keeps the JAX package's 2-texel shift (coordinates are floored
after ``+ 2``), so corner weights are bit-identical to it; the zero ring
itself is replaced by per-corner bounds checks.

``grid_sample`` is the exact render path's sampler and the plain version of
the K1 kernel (``ops/bilinear_sample.py``): corner weights and the blend are
f32 whatever the table dtype, and the result is written in ``out_dtype``.

Images are NHWC; coordinates are [-1, 1] with the last axis (x, y).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_COORD_CLIP = 3.0e4  # keeps integer casts finite for the 1e10 projection sentinel
_EDGE_EPS = 1e-5


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    return ((coord + 1.0) * size - 1.0) * 0.5


def _scrub(v: torch.Tensor) -> torch.Tensor:
    v = torch.nan_to_num(v, nan=-_COORD_CLIP, posinf=_COORD_CLIP, neginf=-_COORD_CLIP)
    return torch.clamp(v, -_COORD_CLIP, _COORD_CLIP)


def pixel_xy(grid: torch.Tensor, H: int, W: int, padding_mode: str):
    """[-1, 1] grid (B, ..., 2) -> unshifted f32 pixel x, y (B, P): border
    clamps into [0, size-1-eps], zeros scrubs non-finite values to the far
    sentinel (the JAX package's ``_pixel_coords``)."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    g = grid.reshape(grid.shape[0], -1, 2)
    x = _unnormalize(g[..., 0].float(), W)
    y = _unnormalize(g[..., 1].float(), H)
    if padding_mode == "border":
        return torch.clamp(x, 0.0, W - 1.0 - _EDGE_EPS), torch.clamp(y, 0.0, H - 1.0 - _EDGE_EPS)
    return _scrub(x), _scrub(y)


def pixel_coords(grid: torch.Tensor, H: int, W: int, padding_mode: str):
    """``pixel_xy`` as the gather samplers floor it: zeros padding shifts by
    the 2-texel ring.  Returns (x, y, shift)."""
    x, y = pixel_xy(grid, H, W, padding_mode)
    if padding_mode == "border":
        return x, y, 0
    return x + 2.0, y + 2.0, 2


def grid_sample(
    image: torch.Tensor,
    grid: torch.Tensor,
    padding_mode: str = "zeros",
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Sample ``image`` (B, H, W, C) at ``grid`` (B, ..., 2) -> (B, ..., C)."""
    B, H, W, C = image.shape
    batch_shape = grid.shape[:-1]
    x, y, shift = pixel_coords(grid.reshape(B, -1, 2), H, W, padding_mode)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = x - x0f
    wy = y - y0f
    x0 = x0f.long() - shift
    y0 = y0f.long() - shift
    flat = image.reshape(B, H * W, C)
    weights = ((1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy)
    out = None
    for (a, b), w in zip(((0, 0), (0, 1), (1, 0), (1, 1)), weights):
        xi = x0 + b
        yi = y0 + a
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C)).float()
        term = v * torch.where(valid, w, torch.zeros_like(w))[..., None]
        out = term if out is None else out + term
    return out.to(out_dtype or image.dtype).reshape(*batch_shape, C)


def grid_sample_dense_nchw(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Dense few-channel warp sampler (zeros padding): image (B, C, H, W),
    grid (B, h, w, 2) -> (B, C, h, w).  The row-pair formulation and blend
    order of the JAX package's ``grid_sample_dense_nchw``."""
    B, C, H, W = image.shape
    batch_shape = grid.shape[:-1]
    x = _scrub(_unnormalize(grid[..., 0].float(), W)) + 2.0
    y = _scrub(_unnormalize(grid[..., 1].float(), H)) + 2.0
    Hp, Wp = H + 4, W + 4
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = (x - x0f).to(image.dtype).reshape(B, 1, -1)
    wy = (y - y0f).to(image.dtype).reshape(B, 1, -1)
    sx = torch.clamp(x0f.long(), 0, Wp - 2)
    sy = torch.clamp(y0f.long(), 0, Hp - 2)
    flat = F.pad(image, (2, 2, 2, 2)).reshape(B, C, Hp * Wp)
    ftop = (sy * Wp + sx).reshape(B, 1, -1).expand(B, C, -1)

    def take(i):
        return torch.gather(flat, 2, i)

    row_t = take(ftop) * (1.0 - wx) + take(ftop + 1) * wx
    row_b = take(ftop + Wp) * (1.0 - wx) + take(ftop + Wp + 1) * wx
    out = row_t * (1.0 - wy) + row_b * wy
    return out.reshape(B, C, *batch_shape[1:])
