"""K3: attention-weighted sum over the samples of sample-major tokens.

Wrapper around ``csrc/weighted_sum.cu``, which replaces
``coponerf_tpu/ops/pallas/weighted_sum.py:weighted_sum_smaj``:

    out[r, n] = sum_s w[r, n, s] * pre[r, s*N + n]            (vsum=None)
    out[b, n] = sum_v sum_s w[b*V+v, n, s] * pre[b*V+v, s*N + n]  (vsum=V)

with f32 accumulation and an f32 result.  On a CPU tensor the wrapper runs
the plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from coponerf_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def weighted_sum_plain(pre: torch.Tensor, w: torch.Tensor, S: int, vsum: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: per view row over s in f32, then over views."""
    R, T, C = pre.shape
    N = T // S
    per_row = (pre.reshape(R, S, N, C).float() * w.float().transpose(1, 2)[..., None]).sum(dim=1)
    if vsum is None:
        return per_row
    return per_row.reshape(R // vsum, vsum, N, C).sum(dim=1)


def weighted_sum_smaj(pre: torch.Tensor, w: torch.Tensor, S: int, vsum: int | None = None) -> torch.Tensor:
    """pre: (R, S*N, C) sample-major tokens; w: (R, N, S) f32 weights.
    Returns (R, N, C) f32, or with ``vsum=V`` the view-row sum (R/V, N, C)."""
    R, T, C = pre.shape
    N = T // S
    if S * N != T or w.shape != (R, N, S):
        raise ValueError(f"bad shapes: pre {tuple(pre.shape)}, w {tuple(w.shape)}, S={S}")
    V = vsum or 1
    if R % V:
        raise ValueError(f"rows {R} not a multiple of vsum={V}")
    if pre.device != w.device:
        raise ValueError("pre and w must be on the same device")
    if pre.device.type == "cpu":
        return weighted_sum_plain(pre, w, S, vsum)
    if pre.device.type != "cuda":
        raise ValueError(f"no kernel for device {pre.device}")
    if pre.dtype not in _DTYPES or w.dtype != torch.float32:
        raise TypeError(f"unsupported dtypes: pre {pre.dtype}, w {w.dtype}")
    if (C * pre.element_size()) % 16 or pre.data_ptr() % 16:
        raise ValueError("pre rows must be 16-byte multiples and 16-byte aligned")
    if not (pre.is_contiguous() and w.is_contiguous()):
        raise ValueError("pre and w must be contiguous")
    out = torch.empty((R // V, N, C), dtype=torch.float32, device=pre.device)
    lib = _build.lib()
    code = lib.k3_weighted_sum(
        pre.data_ptr(), w.data_ptr(), out.data_ptr(), R, V, S, N, C,
        _DTYPES[pre.dtype], _build.stream_of(pre),
    )
    _build.check(code, "k3_weighted_sum")
    weighted_sum_smaj.launches += 1
    return out


weighted_sum_smaj.launches = 0
