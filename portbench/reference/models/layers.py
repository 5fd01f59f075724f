"""Shared building blocks.  Module and attribute names follow the flax
parameter tree of ``coponerf_tpu/models/layers.py`` (e.g. a ``Dense`` holds
its ``nn.Linear`` as ``Dense_0``), so that ``utils/convert.py`` maps every
JAX leaf by a per-leaf layout change only.

Dtype semantics follow flax: a layer with ``dtype`` casts its input and
parameters to it; a layer without one computes in the promotion of the
input dtype and f32 (f32 for bf16 inputs).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def promote(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Input cast of a flax layer: to ``dtype`` if given, else to at least f32."""
    if dtype is not None:
        return x.to(dtype)
    return x if x.dtype == torch.float64 else x.float()


class Dense(nn.Module):
    """flax ``Dense``/``RawDense`` counterpart (param path ``<name>/Dense_0``).
    ``kernel`` is the (in, out) matrix, as the JAX package reads it."""

    def __init__(self, in_features: int, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)
        self.dtype = dtype

    @property
    def kernel(self) -> torch.Tensor:
        return self.Dense_0.weight.t()

    @property
    def bias(self) -> torch.Tensor:
        return self.Dense_0.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = promote(x, self.dtype)
        return F.linear(x, self.Dense_0.weight.to(x.dtype), self.Dense_0.bias.to(x.dtype))


class MLPSeq(nn.Module):
    """Dense layers ``fc{i}`` with relu in between (and optionally first/last)."""

    def __init__(self, in_features: int, features: Sequence[int], act_first: bool = False, act_last: bool = False):
        super().__init__()
        dims = [in_features, *features]
        for i in range(len(features)):
            self.add_module(f"fc{i}", Dense(dims[i], dims[i + 1]))
        self.n = len(features)
        self.act_first = act_first
        self.act_last = act_last

    def forward(self, x):
        if self.act_first:
            x = torch.relu(x)
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
            if i < self.n - 1 or self.act_last:
                x = torch.relu(x)
        return x


class TransformerMlp(nn.Module):
    """fc1 -> exact GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-5)``: statistics and affine in f32,
    result in ``dtype`` (default: the promotion of the input and f32).  The
    variance is flax's E[x^2] - E[x]^2 clipped at 0, not the two-pass
    variance of ``F.layer_norm``: on tokens with a large common offset the
    two differ in the low bits, which the pose head's gradient amplifies
    to percents."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.float()) + self.bias.float()
        return y.to(self.dtype) if self.dtype is not None else y


def group_norm_nd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over (C, *spatial) of (B, C, *spatial) tensors: statistics in
    f32, affine in the input dtype."""
    b, c = x.shape[:2]
    dt = x.dtype
    xg = x.float().reshape(b, num_groups, -1)
    mean = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, unbiased=False, keepdim=True)
    xg = ((xg - mean) / torch.sqrt(var + eps)).to(dt)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return xg.reshape(x.shape) * scale.to(dt).reshape(shape) + bias.to(dt).reshape(shape)


class GroupNormND(nn.Module):
    def __init__(self, num_groups: int, num_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.num_groups = num_groups

    def forward(self, x):
        return group_norm_nd(x, self.weight, self.bias, self.num_groups)


class ConvNHWC(nn.Module):
    """``nn.Conv``/``RawConv`` counterpart on NHWC tensors (symmetric integer
    padding); ``weight`` is torch's (O, I/groups, kh, kw)."""

    def __init__(self, in_features: int, features: int, kernel: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None
        self.stride, self.padding, self.groups, self.dtype = stride, padding, groups, dtype

    def forward(self, x):
        x = promote(x, self.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b,
                     stride=self.stride, padding=self.padding, groups=self.groups)
        return y.permute(0, 2, 3, 1)
