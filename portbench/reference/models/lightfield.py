"""Per-ray light-field MLP decoder (ResnetFC).

Counterpart of ``coponerf_tpu/models/lightfield.py``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from portbench.reference.models.layers import Dense


class ResnetBlockFC(nn.Module):
    def __init__(self, size: int):
        super().__init__()
        self.fc_0 = Dense(size, size)
        self.fc_1 = Dense(size, size)

    def forward(self, x):
        return x + self.fc_1(torch.relu(self.fc_0(torch.relu(x))))


class ResnetFC(nn.Module):
    def __init__(self, d_in: int = 18, d_out: int = 3, n_blocks: int = 3, d_latent: int = 832, d_hidden: int = 128):
        super().__init__()
        self.d_latent, self.n_blocks = d_latent, n_blocks
        self.lin_in = Dense(d_in, d_hidden)
        for i in range(n_blocks):
            self.add_module(f"lin_z_{i}", Dense(d_latent, d_hidden))
            self.add_module(f"block_{i}", ResnetBlockFC(d_hidden))
        self.lin_out = Dense(d_hidden, d_out)

    def forward(self, zx: torch.Tensor) -> torch.Tensor:
        z = zx[..., : self.d_latent]
        x = self.lin_in(zx[..., self.d_latent:])
        for i in range(self.n_blocks):
            x = x + getattr(self, f"lin_z_{i}")(z)
            x = getattr(self, f"block_{i}")(x)
        return self.lin_out(torch.relu(x))
