"""Checkpoints of a training run: ``torch.save`` dicts of the model's
weights and BatchNorm buffers (its ``state_dict``), the optimizer state and
the step counters.

Counterpart of ``coponerf_tpu/training/checkpoint.py:37-99``.  A run
restored into a fresh ``TrainState`` continues bit for bit as the
uninterrupted run would (``tests/test_torch_training_loop.py``, on the CPU,
where every operation of the step is deterministic).  ``restore_into`` and
``load_weights`` also take the JAX package's own ``.npz``
(``utils/jax_checkpoint.py``), and ``load_weights`` the reference's
``.pth``; ``utils/jax_checkpoint.py:save`` writes a state back as a JAX
``.npz``.
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


def _fill_adam_state(opt_sd: dict, optimizer: torch.optim.Optimizer, updates: int) -> dict:
    """``opt_sd`` with zero moments at Adam's step ``updates`` for each
    parameter it holds no state for, once an update has been applied: a
    file written while the step left the parameters that no loss reaches
    out of Adam lacks them, and their moments are zero in optax too."""
    if updates:
        for group_sd, group in zip(opt_sd["param_groups"], optimizer.param_groups):
            for i, p in zip(group_sd["params"], group["params"]):
                if i not in opt_sd["state"]:
                    opt_sd["state"][i] = {"step": torch.tensor(float(updates)), "exp_avg": torch.zeros_like(p),
                                          "exp_avg_sq": torch.zeros_like(p)}
    return opt_sd


def restore_into(state, path: str):
    """Load a checkpoint written by ``save``, or a JAX ``.npz``, into
    ``state`` (in place: the model's tensors and the optimizer keep their
    identity) and return it."""
    if path.endswith(".npz"):
        from coponerf_tpu_torch.utils import jax_checkpoint

        return jax_checkpoint.restore_into(state, path)
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(_fill_adam_state(payload["optimizer"], state.optimizer, int(payload["updates"])))
    for k in _COUNTERS:
        setattr(state, k, int(payload[k]))
    return state


def load_weights(model, path: str, image_size: int = 256):
    """Load weights and BatchNorm buffers into ``model`` (strict) and return
    it: what evaluation needs.  A ``.pth`` file is a reference checkpoint,
    imported by ``utils/torch_import.py`` for ``model``'s configuration at
    ``image_size``; an ``.npz`` one of the JAX package
    (``utils/jax_checkpoint.py``, checked against ``model``); any other is
    a checkpoint written by ``save``."""
    device = next(model.parameters()).device
    if path.endswith(".npz"):
        from coponerf_tpu_torch.utils import jax_checkpoint

        return jax_checkpoint.load_weights(model, path)
    if path.endswith(".pth"):
        from coponerf_tpu_torch.utils.torch_import import import_reference

        sd = import_reference(path, model.cfg, image_size)
    else:
        sd = torch.load(path, map_location=device, weights_only=True)["model"]
    model.load_state_dict(sd, strict=True)
    return model
