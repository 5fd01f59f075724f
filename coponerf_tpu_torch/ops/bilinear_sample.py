"""K1: bilinear sampling of latent tables at epipolar points.

Wrapper around ``csrc/bilinear_sample.cu``, which replaces the TPU's
``coponerf_tpu/ops/pallas/bilinear_sample.py:onehot_matmul_sample_xy`` (a
banded one-hot selection matmul) with a direct 4-corner gather, and also
serves the 256^2 level that the JAX package samples with XLA's gather.

On a CPU tensor the wrapper runs the plain version,
``ops/grid_sample.py:grid_sample`` (same pixel coordinates, f32 weights and
blend).  On a CUDA tensor it launches the kernel or raises.  Tables are bf16
(the fast path's only use); the exact path samples with ``grid_sample``.
"""

from __future__ import annotations

import torch

from coponerf_tpu_torch.ops import _build
from coponerf_tpu_torch.ops.grid_sample import grid_sample


def bilinear_sample_plain(image: torch.Tensor, grid: torch.Tensor, padding_mode: str) -> torch.Tensor:
    """Plain PyTorch version: the exact gather in the table dtype."""
    return grid_sample(image, grid, padding_mode, out_dtype=image.dtype)


def bilinear_sample(image: torch.Tensor, grid: torch.Tensor, padding_mode: str) -> torch.Tensor:
    """Sample ``image`` (B, H, W, C) at [-1, 1] ``grid`` (B, ..., 2) with
    ``border`` or ``zeros`` padding (align_corners=False) -> (B, ..., C)
    bf16.  ``image`` is bf16, ``grid`` f32."""
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    if image.dim() != 4 or grid.shape[0] != image.shape[0] or grid.shape[-1] != 2:
        raise ValueError(f"bad shapes: image {tuple(image.shape)}, grid {tuple(grid.shape)}")
    if image.device != grid.device:
        raise ValueError("image and grid must be on the same device")
    if image.dtype != torch.bfloat16 or grid.dtype != torch.float32:
        raise TypeError(f"unsupported dtypes: image {image.dtype} (bf16 only), grid {grid.dtype} (f32 only)")
    if image.device.type == "cpu":
        return bilinear_sample_plain(image, grid, padding_mode)
    if image.device.type != "cuda":
        raise ValueError(f"no kernel for device {image.device}")
    B, H, W, C = image.shape
    if C % 8:
        raise ValueError(f"channel rows must be a multiple of 16 bytes (8 bf16), got C={C}")
    if not (image.is_contiguous() and grid.is_contiguous()):
        raise ValueError("image and grid must be contiguous")
    if image.data_ptr() % 16:
        raise ValueError("image must be 16-byte aligned")
    batch_shape = grid.shape[:-1]
    P = grid[0].numel() // 2
    out = torch.empty((B, P, C), dtype=image.dtype, device=image.device)
    lib = _build.lib()
    code = lib.k1_bilinear_sample(
        image.data_ptr(), grid.data_ptr(), out.data_ptr(), B, H, W, C, P,
        int(padding_mode == "zeros"), _build.stream_of(image),
    )
    _build.check(code, "k1_bilinear_sample")
    bilinear_sample.launches += 1
    return out.reshape(*batch_shape, C)


bilinear_sample.launches = 0
