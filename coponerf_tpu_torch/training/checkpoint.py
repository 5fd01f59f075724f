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
``.npz``.  A file keeps the optimizer layout of the run that wrote it
(per leaf, or ``flat_optimizer``'s one vector); ``restore_into`` converts
it to the restoring run's.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from coponerf_tpu_torch.training.optim import load_adam_state, split

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


def _saved_moments(path: str, opt_sd: dict, model, updates: int) -> dict:
    """{parameter name: (exp_avg, exp_avg_sq)} of a saved optimizer state
    in either layout (one entry a parameter, or the flat optimizer's one
    vector in ``named_parameters`` order), zeros where it holds none.
    Raises ``ValueError`` where the state fits neither layout of ``model``
    or its steps are not ``updates``."""
    named = list(model.named_parameters())
    names, shapes = [k for k, _ in named], [p.shape for _, p in named]
    ids = [i for g in opt_sd["param_groups"] for i in g["params"]]
    saved = opt_sd["state"]
    if len(ids) == 1 and len(named) > 1:
        st = saved.get(ids[0])
        held = {}
        if st is not None:
            size = sum(p.numel() for _, p in named)
            if st["exp_avg"].numel() != size:
                raise ValueError(f"{path}: a flat Adam state of {st['exp_avg'].numel()} values; the model's "
                                 f"parameters hold {size}")
            mu, nu = split(st["exp_avg"], names, shapes), split(st["exp_avg_sq"], names, shapes)
            held = {k: (mu[k], nu[k], st["step"]) for k in names}
    elif len(ids) == len(named):
        held = {k: (st["exp_avg"], st["exp_avg_sq"], st["step"]) for k, i in zip(names, ids)
                if (st := saved.get(i)) is not None}
        bad = [k for k, p in named if k in held and held[k][0].shape != p.shape]
        if bad:
            raise ValueError(f"{path}: Adam state of another shape than the parameter's: {bad[:8]}")
    else:
        raise ValueError(f"{path}: Adam state for {len(ids)} parameters; the model has {len(named)} (per-leaf) "
                         "or one vector (flat_optimizer)")
    steps = {int(step) for _, _, step in held.values()}
    if steps - {updates}:
        raise ValueError(f"{path}: Adam's steps {sorted(steps)} are not the file's {updates} updates")
    return {k: held[k][:2] if k in held else (torch.zeros_like(p, device="cpu"), torch.zeros_like(p, device="cpu"))
            for k, p in named}


def restore_into(state, path: str):
    """Load a checkpoint written by ``save``, or a JAX ``.npz``, into
    ``state`` (in place: the model's tensors and the optimizer keep their
    identity) and return it.  A ``.pt`` whose Adam state is in the other
    layout (per leaf or ``flat_optimizer``) than ``state``'s is converted;
    one that fits neither raises ``ValueError`` before anything loads."""
    if path.endswith(".npz"):
        from coponerf_tpu_torch.utils import jax_checkpoint

        return jax_checkpoint.restore_into(state, path)
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    want = state.model.state_dict()
    bad = sorted(set(want) ^ set(payload["model"])) or [k for k, v in payload["model"].items()
                                                         if v.shape != want[k].shape]
    if bad:
        raise ValueError(f"{path}: weights that do not fit the model (missing, left over or of another shape): "
                         f"{bad[:8]}")
    opt_sd, updates = payload["optimizer"], int(payload["updates"])
    n_ids = sum(len(g["params"]) for g in opt_sd["param_groups"])
    same_layout = n_ids == sum(len(g["params"]) for g in state.optimizer.param_groups)
    # checked in every case where a flat vector is involved: its size is not in the group count
    moments = (_saved_moments(path, opt_sd, state.model, updates)
               if not same_layout or state.flat is not None else None)
    state.model.load_state_dict(payload["model"], strict=True)
    if same_layout:
        state.optimizer.load_state_dict(_fill_adam_state(opt_sd, state.optimizer, updates))
    elif updates:
        load_adam_state(state, moments, updates)
    else:
        state.optimizer.state.clear()
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
