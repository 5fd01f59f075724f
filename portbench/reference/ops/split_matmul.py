"""K2's plain expression: split-input W1 + bias + relu, then the folded key
head, in f32 with autograd's own backward.

    out = relu(concat(p0, p1, p2, pc, pt) @ kernel + bias)
    k   = out @ fk
"""

from __future__ import annotations

import torch


def split_dense_relu(parts, kernel: torch.Tensor, bias: torch.Tensor, fk: torch.Tensor):
    """parts: (p0, p1, p2, pc, pt), each (R, T, K_i).  Returns (out (R, T, N),
    k (R, T, NK))."""
    x = torch.cat([p.float() for p in parts], dim=-1)
    out = torch.relu(x @ kernel.float() + bias.float())
    return out, out @ fk.float()
