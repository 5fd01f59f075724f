"""Checkpoints of a training run: ``torch.save`` dicts of the model's
weights and BatchNorm buffers (its ``state_dict``), the optimizer state and
the step counters.

Counterpart of ``coponerf_tpu/training/checkpoint.py:37-99`` (which writes
npz).  A run restored into a fresh ``TrainState`` continues bit for bit as
the uninterrupted run would (``tests/test_torch_checkpoint.py``, on the
CPU, where every operation of the step is deterministic).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

_COUNTERS = ("step", "updates", "notfinite_count", "total_notfinite")


def save(ckpt_dir: str, state, step: int, name: Optional[str] = None) -> str:
    """Write ``state`` to ``<ckpt_dir>/<name or model_step_XXXXXXXX>.pt``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, (name or f"model_step_{step:08d}") + ".pt")
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        **{k: getattr(state, k) for k in _COUNTERS},
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_into(state, path: str):
    """Load a checkpoint written by ``save`` into ``state`` (in place: the
    model's tensors and the optimizer keep their identity) and return it."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    for k in _COUNTERS:
        setattr(state, k, int(payload[k]))
    return state


def load_weights(model, path: str):
    """Load the weights and BatchNorm buffers of a checkpoint written by
    ``save`` into ``model`` (strict) and return it: what evaluation needs."""
    device = next(model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    return model
