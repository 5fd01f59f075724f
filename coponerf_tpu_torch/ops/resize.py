"""Separable bilinear resizing as two small dense contractions.

Counterpart of ``coponerf_tpu/ops/resize.py``: the same (out, in)
interpolation matrices, built with numpy, so both ``align_corners``
conventions match ``torch.nn.functional.interpolate(mode='bilinear')`` and
the JAX package to f32 round-off.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from coponerf_tpu_torch import trace


@functools.lru_cache(maxsize=None)
def _linear_weights_np(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out_size, in_size) row-stochastic bilinear interpolation matrix."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    out_idx = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            src = np.zeros_like(out_idx)
        else:
            src = out_idx * (in_size - 1) / (out_size - 1)
    else:
        src = (out_idx + 0.5) * in_size / out_size - 0.5
        src = np.maximum(src, 0.0)
    x0 = np.floor(src).astype(np.int64)
    x0 = np.clip(x0, 0, in_size - 1)
    x1 = np.minimum(x0 + 1, in_size - 1)
    w1 = src - x0
    w0 = 1.0 - w1
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    mat[np.arange(out_size), x0] += w0
    mat[np.arange(out_size), x1] += w1
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _linear_weights(in_size: int, out_size: int, align_corners: bool, device: torch.device,
                    dtype: torch.dtype) -> torch.Tensor:
    """``_linear_weights_np``'s matrix on ``device`` in ``dtype``, copied
    once a key: it is read, never written, and the copy blocks the host
    (a CUDA graph could not capture it).  Outside inference mode, so that
    autograd may save it."""
    with torch.inference_mode(False):
        w = torch.from_numpy(_linear_weights_np(in_size, out_size, align_corners))
        w = w.to(device=device, dtype=dtype)
    trace.count("host_syncs")        # a blocking host-to-device copy
    return w


def _contract(x: torch.Tensor, ax: int, out_size: int, align_corners: bool) -> torch.Tensor:
    w = _linear_weights(x.shape[ax], out_size, align_corners, x.device, x.dtype)
    return torch.movedim(torch.tensordot(w, x, dims=([1], [ax])), 0, ax)


def resize_bilinear(
    x: torch.Tensor,
    out_hw: tuple[int, int],
    align_corners: bool = False,
    axes: tuple[int, int] = (-3, -2),
) -> torch.Tensor:
    """Bilinearly resize two axes of ``x`` (default: H, W of an NHWC tensor)."""
    h_ax = axes[0] % x.dim()
    w_ax = axes[1] % x.dim()
    if x.shape[h_ax] != out_hw[0]:
        x = _contract(x, h_ax, out_hw[0], align_corners)
    if x.shape[w_ax] != out_hw[1]:
        x = _contract(x, w_ax, out_hw[1], align_corners)
    return x


def resize_nchw(x: torch.Tensor, out_hw: tuple[int, int], align_corners: bool = False) -> torch.Tensor:
    """Resize the trailing two axes of an NCHW tensor."""
    return resize_bilinear(x, out_hw, align_corners, axes=(-2, -1))
