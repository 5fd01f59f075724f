"""K1, K8 and K4: bilinear sampling of latent tables and its backward.

Wrappers around ``csrc/bilinear_sample.cu`` and ``csrc/transpose_sample.cu``:

- ``bilinear_sample`` (K1) replaces
  ``coponerf_tpu/ops/pallas/bilinear_sample.py:onehot_matmul_sample_xy`` (a
  banded one-hot selection matmul) with a direct 4-corner gather: the
  multi-level entry below with one level, bf16 out.  Tables are bf16; the
  exact path samples with ``ops/grid_sample.py``.
- ``multilevel_sample`` (K8a) replaces
  ``coponerf_tpu/ops/pallas/experimental/multilevel_sample.py:multilevel_banded_sample``:
  1 to 4 levels sampled at one shared grid in one launch, each level's
  output bit for bit a one-level launch's.  The fast inference render
  samples all four latent levels of a sample set with it.
- ``grid_sample_window`` (K8b) replaces
  ``experimental/windowed_sample.py:grid_sample_onehot_window`` (the
  large-table sampler, f32 output by default): the same entry with one
  level.
- ``corner_sample`` (K1's second entry) replaces ``onehot_matmul_sample``:
  the same gather from precomputed corner ids and weights (B, P, 4).
- ``onehot_transpose_matmul`` (K4) replaces the kernel of the same name:
  the scatter-add of point cotangents into the table gradient.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises, and counts the launch.

The differentiable samplers of the training path pass gradients to the
table only; the grid gets none, which is exact for the renderer's latent
sampling, whose coordinates come from ground-truth poses
(``bilinear_sample.py:630-666``).  Never use them where the grid needs a
gradient (flow warps use ``ops/grid_sample.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from coponerf_tpu_torch.ops import _build
from coponerf_tpu_torch.ops.grid_sample import grid_sample, pixel_xy

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LEVELS = 4


def _kernel_device(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def _check_xy_args(tables: Sequence[torch.Tensor], grid: torch.Tensor, padding_mode: str,
                   out_dtype: torch.dtype) -> bool:
    """The xy samplers' argument checks; True where the kernel runs."""
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    for t in tables:
        if t.dim() != 4 or grid.shape[0] != t.shape[0] or grid.shape[-1] != 2:
            raise ValueError(f"bad shapes: table {tuple(t.shape)}, grid {tuple(grid.shape)}")
        if t.device != grid.device:
            raise ValueError("tables and grid must be on the same device")
        if t.dtype != torch.bfloat16 or grid.dtype != torch.float32:
            raise TypeError(f"unsupported dtypes: table {t.dtype} (bf16 only), grid {grid.dtype} (f32 only)")
    if not _kernel_device(grid):
        return False
    for t in tables:
        if t.shape[-1] % 8:
            raise ValueError(f"channel rows must be a multiple of 16 bytes (8 bf16), got C={t.shape[-1]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("tables must be contiguous and 16-byte aligned")
    if not grid.is_contiguous() or grid.data_ptr() % 8:
        raise ValueError("grid must be contiguous and 8-byte aligned")
    return True


def _launch_levels(tables: Sequence[torch.Tensor], grid: torch.Tensor, padding_mode: str,
                   out_dtype: torch.dtype) -> List[torch.Tensor]:
    """One ``k1_multilevel_sample`` launch over ``tables``; it refuses a
    batch over 65535 rows or a level of 2^31 or more elements (points x C,
    or H x W x C) a row."""
    n = len(tables)
    B, batch_shape = grid.shape[0], grid.shape[:-1]
    P = grid[0].numel() // 2
    outs = [torch.empty((B, P, t.shape[-1]), dtype=out_dtype, device=grid.device) for t in tables]
    pad = [tables[0]] * (_MAX_LEVELS - n)
    dims = [d for t in list(tables) + pad for d in t.shape[1:]]
    code = _build.lib().k1_multilevel_sample(
        grid.data_ptr(), n, *(t.data_ptr() for t in list(tables) + pad),
        *(o.data_ptr() for o in outs + [outs[0]] * (_MAX_LEVELS - n)), *dims, B, P,
        int(padding_mode == "zeros"), int(out_dtype == torch.float32), _build.stream_of(grid),
    )
    _build.check(code, "k1_multilevel_sample")
    return [o.reshape(*batch_shape, o.shape[-1]) for o in outs]


# --------------------------------------------------------------- K1 (xy) --

def bilinear_sample_plain(image: torch.Tensor, grid: torch.Tensor, padding_mode: str) -> torch.Tensor:
    """Plain PyTorch version: the exact gather in the table dtype."""
    return grid_sample(image, grid, padding_mode, out_dtype=image.dtype)


def bilinear_sample(image: torch.Tensor, grid: torch.Tensor, padding_mode: str) -> torch.Tensor:
    """Sample ``image`` (B, H, W, C) at [-1, 1] ``grid`` (B, ..., 2) with
    ``border`` or ``zeros`` padding (align_corners=False) -> (B, ..., C)
    bf16.  ``image`` is bf16, ``grid`` f32.  The multi-level entry with one
    level."""
    if not _check_xy_args([image], grid, padding_mode, torch.bfloat16):
        return bilinear_sample_plain(image, grid, padding_mode)
    (out,) = _launch_levels([image], grid, padding_mode, torch.bfloat16)
    bilinear_sample.launches += 1
    return out


bilinear_sample.launches = 0


# ------------------------------------------------------------------- K8 --

def multilevel_sample_plain(tables: Sequence[torch.Tensor], grid: torch.Tensor, padding_mode: str,
                            out_dtype: torch.dtype = torch.bfloat16) -> List[torch.Tensor]:
    """Plain PyTorch version: the exact gather of each level."""
    return [grid_sample(t, grid, padding_mode, out_dtype=out_dtype) for t in tables]


def multilevel_sample(tables: Sequence[torch.Tensor], grid: torch.Tensor, padding_mode: str,
                      out_dtype: torch.dtype = torch.bfloat16) -> List[torch.Tensor]:
    """Sample 1 to 4 tables (B, H_l, W_l, C_l) bf16 at one [-1, 1] ``grid``
    (B, ..., 2) f32 -> one contiguous (B, ..., C_l) ``out_dtype`` tensor a
    level, in one launch.  Padding and arithmetic as ``bilinear_sample``."""
    if not 1 <= len(tables) <= _MAX_LEVELS:
        raise ValueError(f"1 to {_MAX_LEVELS} levels, got {len(tables)}")
    if not _check_xy_args(tables, grid, padding_mode, out_dtype):
        return multilevel_sample_plain(tables, grid, padding_mode, out_dtype)
    outs = _launch_levels(tables, grid, padding_mode, out_dtype)
    multilevel_sample.launches += 1
    return outs


multilevel_sample.launches = 0


def grid_sample_window_plain(image: torch.Tensor, grid: torch.Tensor, padding_mode: str = "zeros",
                             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: the exact gather."""
    return grid_sample(image, grid, padding_mode, out_dtype=out_dtype)


def grid_sample_window(image: torch.Tensor, grid: torch.Tensor, padding_mode: str = "zeros",
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sample one large table ``image`` (B, H, W, C) bf16 at [-1, 1] ``grid``
    (B, ..., 2) f32 -> (B, ..., C) in ``out_dtype`` (f32 by default): the
    multi-level entry with one level."""
    if not _check_xy_args([image], grid, padding_mode, out_dtype):
        return grid_sample_window_plain(image, grid, padding_mode, out_dtype)
    (out,) = _launch_levels([image], grid, padding_mode, out_dtype)
    grid_sample_window.launches += 1
    return out


grid_sample_window.launches = 0


# ------------------------------------------------------ corner ids, weights --

def bilinear_corner_decomposition(grid: torch.Tensor, H: int, W: int, padding_mode: str):
    """The ``grid_sample`` semantics as in-image flat corner ids (B, P, 4)
    int32 and weights (B, P, 4) f32, corners in the order (y, x) = (0, 0),
    (0, 1), (1, 0), (1, 1).  Zeros padding clamps the ids of out-of-image
    corners into the image and zeroes their weights."""
    x, y = pixel_xy(grid, H, W, padding_mode)
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = x - x0f, y - y0f
    x0, y0 = x0f.int(), y0f.int()
    weights = ((1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy)
    idxs, ws = [], []
    for (a, b), wc in zip(((0, 0), (0, 1), (1, 0), (1, 1)), weights):
        xi, yi = x0 + b, y0 + a
        if padding_mode == "zeros":
            valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            wc = wc * valid.float()
            xi, yi = xi.clamp(0, W - 1), yi.clamp(0, H - 1)
        idxs.append(yi * W + xi)
        ws.append(wc)
    return torch.stack(idxs, dim=-1), torch.stack(ws, dim=-1)


def corners_from_pixel_xy(x: torch.Tensor, y: torch.Tensor, w_img: int, zeros_mode: bool):
    """Pixel x, y (B, P) -> corner ids and weights (B, P, 4), as the one-hot
    sampler's backward builds them: under zeros padding a corner left of,
    right of or above the image gets id -1 and weight 0; one below the image
    keeps its weight and an id >= H*W, which K4 skips."""
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = x - x0f, y - y0f
    x0, y0 = x0f.int(), y0f.int()
    idxs, ws = [], []
    for a in (0, 1):
        for b in (0, 1):
            wc = (wx if b else 1.0 - wx) * (wy if a else 1.0 - wy)
            xi, yi = x0 + b, y0 + a
            idx = yi * w_img + xi
            if zeros_mode:
                valid = (xi >= 0) & (xi < w_img) & (yi >= 0)
                idx = torch.where(valid, idx, torch.full_like(idx, -1))
                wc = wc * valid.float()
            idxs.append(idx)
            ws.append(wc)
    return torch.stack(idxs, dim=-1), torch.stack(ws, dim=-1)


# ---------------------------------------------------------- K1 (corner ids) --

def _check_corners(idx: torch.Tensor, w: torch.Tensor, B: int, P: int, device) -> None:
    if idx.shape != (B, P, 4) or w.shape != (B, P, 4):
        raise ValueError(f"bad corner shapes: idx {tuple(idx.shape)}, w {tuple(w.shape)}, want ({B}, {P}, 4)")
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"corner ids must be int32 and weights f32, got {idx.dtype}, {w.dtype}")
    if idx.device != device or w.device != device:
        raise ValueError("corners must lie on the data's device")


def corner_sample_plain(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version: f32 products of the table rows at the in-table
    corner ids with their weights, summed corner by corner."""
    B, HW, C = table.shape
    valid = (idx >= 0) & (idx < HW)
    out = None
    for c in range(4):
        rows = idx[..., c].clamp(0, HW - 1).long()
        v = torch.gather(table, 1, rows[..., None].expand(-1, -1, C)).float()
        term = v * torch.where(valid[..., c], w[..., c], torch.zeros_like(w[..., c]))[..., None]
        out = term if out is None else out + term
    return out.to(out_dtype)


def corner_sample(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """sum_c w[b,p,c] * table[b, idx[b,p,c]] -> (B, P, C) in ``out_dtype``
    (f32 or bf16).  ``table`` (B, HW, C) bf16; ids outside [0, HW) are
    skipped."""
    if table.dim() != 3 or table.dtype != torch.bfloat16:
        raise TypeError(f"table must be (B, HW, C) bf16, got {tuple(table.shape)} {table.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    B, HW, C = table.shape
    P = idx.shape[1]
    _check_corners(idx, w, B, P, table.device)
    if not _kernel_device(table):
        return corner_sample_plain(table, idx, w, out_dtype)
    if C % 8:
        raise ValueError(f"channel rows must be a multiple of 8, got C={C}")
    if not (table.is_contiguous() and idx.is_contiguous() and w.is_contiguous()):
        raise ValueError("table, idx and w must be contiguous")
    if table.data_ptr() % 16 or idx.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("table, idx and w must be 16-byte aligned")
    out = torch.empty((B, P, C), dtype=out_dtype, device=table.device)
    code = _build.lib().k1_corner_sample(
        table.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), B, HW, C, P,
        int(out_dtype == torch.float32), _build.stream_of(table),
    )
    _build.check(code, "k1_corner_sample")
    corner_sample.launches += 1
    return out


corner_sample.launches = 0


# --------------------------------------------------------------------- K4 --

def onehot_transpose_matmul_plain(g: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, HW: int) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of the weighted f32 cotangents
    over the flattened corners (skipped corners add zero)."""
    B, P, C = g.shape
    valid = (idx >= 0) & (idx < HW) & (w != 0)
    rows = idx.clamp(0, HW - 1).long() + torch.arange(B, device=g.device)[:, None, None] * HW
    contrib = g.float()[:, :, None, :] * torch.where(valid, w, torch.zeros_like(w))[..., None]
    out = torch.zeros((B * HW, C), dtype=torch.float32, device=g.device)
    out.index_add_(0, rows.reshape(-1), contrib.reshape(-1, C))
    return out.reshape(B, HW, C)


def onehot_transpose_matmul(g: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, HW: int) -> torch.Tensor:
    """g (B, P, C) f32 or bf16, corner ids (B, P, 4) int32 and weights
    (B, P, 4) f32 -> dtable (B, HW, C) f32 with
    dtable[b, idx[b,p,c]] += w[b,p,c] * g[b,p] over corners with
    0 <= idx < HW and w != 0.  On CUDA the sum order follows the atomics."""
    if g.dim() != 3 or g.dtype not in _DTYPES:
        raise TypeError(f"g must be (B, P, C) f32 or bf16, got {tuple(g.shape)} {g.dtype}")
    B, P, C = g.shape
    _check_corners(idx, w, B, P, g.device)
    if not _kernel_device(g):
        return onehot_transpose_matmul_plain(g, idx, w, HW)
    if not (g.is_contiguous() and idx.is_contiguous() and w.is_contiguous()):
        raise ValueError("g, idx and w must be contiguous")
    if g.data_ptr() % 16 or idx.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("g, idx and w must be 16-byte aligned")
    if C % 8:
        raise ValueError(f"channel rows must be a multiple of 8, got C={C}")
    if P >= 2 ** 31:
        raise ValueError(f"K4 indexes points in 32 bits, got P={P}")
    out = torch.zeros((B, HW, C), dtype=torch.float32, device=g.device)
    perm = torch.empty((B, P), dtype=torch.int32, device=g.device)  # the points' order by cell
    code = _build.lib().k4_transpose_sample(
        g.data_ptr(), idx.data_ptr(), w.data_ptr(), perm.data_ptr(), out.data_ptr(), B, P, HW, C,
        _DTYPES[g.dtype], _build.stream_of(g),
    )
    _build.check(code, "k4_transpose_sample")
    onehot_transpose_matmul.launches += 1
    return out


onehot_transpose_matmul.launches = 0


# ------------------------------------------------ differentiable samplers --

class _TableGradSample(torch.autograd.Function):
    """``grid_sample`` forward (the f32-blend gather), K4 backward."""

    @staticmethod
    def forward(ctx, image, grid, padding_mode):
        ctx.save_for_backward(grid)
        ctx.meta = (image.shape, image.dtype, padding_mode)
        return grid_sample(image, grid, padding_mode)

    @staticmethod
    def backward(ctx, g):
        (grid,) = ctx.saved_tensors
        (B, H, W, C), dtype, mode = ctx.meta
        idx, w = bilinear_corner_decomposition(grid, H, W, mode)
        dtab = onehot_transpose_matmul(g.reshape(B, -1, C).contiguous(), idx, w, H * W)
        return dtab.reshape(B, H, W, C).to(dtype), None, None


def grid_sample_tablegrad(image: torch.Tensor, grid: torch.Tensor, padding_mode: str = "zeros") -> torch.Tensor:
    """``ops.grid_sample`` with its gradient to ``image`` (B, H, W, C) only,
    computed by K4 from ``bilinear_corner_decomposition``."""
    return _TableGradSample.apply(image, grid, padding_mode)


class _OnehotSampleXY(torch.autograd.Function):
    """K1 forward on a bf16 table, K4 backward from the unshifted pixel
    corners (``corners_from_pixel_xy``)."""

    @staticmethod
    def forward(ctx, table, grid, padding_mode):
        ctx.save_for_backward(grid)
        ctx.meta = (table.shape, padding_mode)
        return bilinear_sample(table, grid, padding_mode)

    @staticmethod
    def backward(ctx, g):
        (grid,) = ctx.saved_tensors
        (B, H, W, C), mode = ctx.meta
        x, y = pixel_xy(grid, H, W, mode)
        idx, w = corners_from_pixel_xy(x, y, W, mode != "border")
        dtab = onehot_transpose_matmul(g.reshape(B, -1, C).contiguous(), idx, w, H * W)
        return dtab.reshape(B, H, W, C).to(torch.bfloat16), None, None


def grid_sample_onehot(image: torch.Tensor, grid: torch.Tensor, padding_mode: str = "zeros") -> torch.Tensor:
    """The training path's sampler for the <=64^2 levels: ``image``
    (B, H, W, C) is cast to bf16 (the cast's own backward carries the
    gradient to an f32 table), sampled by K1, with the K4 table gradient.
    Returns (B, ..., C) bf16."""
    return _OnehotSampleXY.apply(image.to(torch.bfloat16).contiguous(), grid.float().contiguous(), padding_mode)


class _OnehotSampleCorners(torch.autograd.Function):
    """K1's corner-id entry forward, K4 backward from the same corners."""

    @staticmethod
    def forward(ctx, table, idx, w, out_dtype):
        ctx.save_for_backward(idx, w)
        ctx.meta = (table.shape[1], table.dtype)
        return corner_sample(table, idx, w, out_dtype)

    @staticmethod
    def backward(ctx, g):
        idx, w = ctx.saved_tensors
        HW, dtype = ctx.meta
        dtab = onehot_transpose_matmul(g.contiguous(), idx, w, HW)
        return dtab.to(dtype), None, None, None


def onehot_sample_diff(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Differentiable corner-id sampling of ``table`` (B, HW, C) bf16; the
    gradient flows to the table only."""
    return _OnehotSampleCorners.apply(table, idx, w, out_dtype)
