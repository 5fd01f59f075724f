"""The model's weights, drawn from the run's seed on the device.

One ``torch.Generator`` on the weights' device, seeded with the run's seed,
draws one normal vector for every tensor of the state dict at once, in the
state dict's order; each tensor takes its slice under the rule for its
kind: norm scales and running variances 1, biases and running means 0,
``pos_embed`` N(0, 0.02), every other (2-D and wider) weight a normal
scaled by 1/sqrt(fan-in), the fan-in being the product of every axis but
the first (torch's (out, in, ...) layout).  The program and the reference
have the same state dict, so the same seed gives both the same weights.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _scale(name: str, shape) -> float | None:
    """The normal's scale for a tensor, or None for a constant one."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("bias", "running_mean", "running_var") or (leaf == "weight" and len(shape) == 1):
        return None
    if leaf == "pos_embed":
        return 0.02
    return 1.0 / math.sqrt(max(math.prod(shape[1:]), 1))


def draw_state_dict(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """A state dict for ``model``: f32 tensors on ``device`` from ``seed``."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    total = sum(math.prod(s) for k, s in shapes.items() if _scale(k, s) is not None)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    normal = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for k, s in shapes.items():
        scale = _scale(k, s)
        if scale is None:
            leaf = k.rsplit(".", 1)[-1]
            fill = 0.0 if leaf in ("bias", "running_mean") else 1.0
            out[k] = torch.full(s, fill, dtype=torch.float32, device=device)
            continue
        n = math.prod(s)
        out[k] = normal[off: off + n].view(s).mul_(scale)
        off += n
    return out


def load_weights(model: torch.nn.Module, seed: int, device) -> torch.nn.Module:
    """Move ``model`` to ``device`` and fill it from ``seed`` in place."""
    model = model.to(device)
    sd = model.state_dict()
    with torch.no_grad():
        for k, v in draw_state_dict(model, seed, device).items():
            sd[k].copy_(v)
    return model
