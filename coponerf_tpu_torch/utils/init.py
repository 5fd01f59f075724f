"""Seeded parameter fill for the port, without JAX.

Same name rules as ``coponerf_tpu/utils/fast_init.py``: norm scales and
variances -> 1, biases and means -> 0, ``pos_embed`` -> N(0, 0.02), kernels
-> normal scaled by 1/sqrt(fan-in).  Leaves are drawn in the flax tree's
order and flax layout from one ``numpy.random.RandomState(seed)``, so for
the same model and seed the result equals ``convert(fast_init(...))`` of
the JAX package exactly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from coponerf_tpu_torch.utils.convert import convert, flax_path


def _fill(name: str, shape, rng: np.random.RandomState) -> np.ndarray:
    if name in ("bias", "mean"):
        return np.zeros(shape, np.float32)
    if name in ("scale", "var"):
        return np.ones(shape, np.float32)
    if name == "pos_embed":
        return (rng.randn(*shape) * 0.02).astype(np.float32)
    fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else max(shape[0], 1)
    return (rng.randn(*shape) / np.sqrt(max(fan_in, 1))).astype(np.float32)


def init_state_dict(model: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded ``state_dict`` for ``model`` (f32, on the CPU)."""
    leaves = sorted(flax_path(k, tuple(v.shape)) for k, v in model.state_dict().items())
    rng = np.random.RandomState(seed)
    tree: dict = {}
    for path, shape in leaves:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _fill(path[-1], shape, rng)
    return convert(tree)


def init_weights(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Fill ``model`` in place (strict load) and return it."""
    model.load_state_dict(init_state_dict(model, seed), strict=True)
    return model
