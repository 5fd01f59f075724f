"""Correlation-guided cross-attention pose head.

Counterpart of ``coponerf_tpu/models/cross_block.py``, with the same
transposed positional-encoding token order and the same flip on return.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from portbench.reference.models.layers import Dense, LayerNorm, TransformerMlp


def get_positional_encodings(n_tokens: int, intrinsics):
    """(y^2, x^2, xy, y, x, 1) per token; intrinsics = (fx, fy, cx, cy),
    each (B, 1), normalized to a 0-1 image.  Token i -> (x = xs[i // h],
    y = ys[i % h])."""
    fx, fy, cx, cy = intrinsics
    h = w = int(round(n_tokens ** 0.5))
    ys = torch.linspace(-1.0, 1.0, h, dtype=fx.dtype, device=fx.device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=fx.dtype, device=fx.device)
    p3 = ys.repeat(w)[None] * (cy / fy)
    p4 = xs.repeat_interleave(h)[None] * (cx / fx)
    ones = torch.ones_like(p3)
    return torch.stack([p3 * p3, p4 * p4, p3 * p4, p3, p4, ones], dim=-1)


class CrossAttention(nn.Module):
    def __init__(self, dim: int = 256):
        super().__init__()
        self.proj_fundamental = Dense(dim + 6, dim)

    def forward(self, x1, x2, corr, intrinsics):
        """x1/x2: (B, N, C) normalized tokens; corr: (B, 1, N, N)."""
        B, N, C = x1.shape
        attn_1 = corr[:, 0].reshape(B, N, N)
        attn_2 = attn_1.transpose(-1, -2)
        af1 = torch.softmax(attn_1, dim=-1) * torch.softmax(attn_1, dim=-2)
        af2 = torch.softmax(attn_2, dim=-1) * torch.softmax(attn_2, dim=-2)
        positional = get_positional_encodings(N, intrinsics).to(x1.dtype)
        v1 = torch.cat([x1, positional], dim=-1)
        v2 = torch.cat([x2, positional], dim=-1)
        f1 = torch.einsum("bnc,bnm,bmd->bcd", v1, af1, v1).transpose(-1, -2)
        f2 = torch.einsum("bnc,bnm,bmd->bcd", v2, af2, v2).transpose(-1, -2)
        return self.proj_fundamental(f2), self.proj_fundamental(f1)


class CrossBlock(nn.Module):
    def __init__(self, dim: int = 256, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.cross_attn = CrossAttention(dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = TransformerMlp(dim, int(dim * mlp_ratio), dim)
        self.norm = LayerNorm(dim)

    def forward(self, x, corr, intrinsics):
        """x: (B*2, N, C) tokens of both context views -> (B, 2*(C+6), C)."""
        _, n, c = x.shape
        x = x.reshape(-1, 2, n, c)
        f1, f2 = self.cross_attn(self.norm1(x[:, 0]), self.norm1(x[:, 1]), corr, intrinsics)
        fundamental = torch.cat([f1[:, None], f2[:, None]], dim=1).reshape(x.shape[0], -1, c)
        fundamental = fundamental + self.mlp(self.norm2(fundamental))
        return self.norm(fundamental)
