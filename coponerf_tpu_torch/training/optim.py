"""Adam's state in the two layouts of the train step: one entry a
parameter, or ``TrainConfig.flat_optimizer``'s one vector of every
parameter (``optax.flatten``), and the by-name view of it that the
checkpoint readers and writers share.

``FlatParameters`` makes every parameter of a model a view into one f32
vector, in the order of ``named_parameters()``, and its ``.grad`` a view
into one f32 gradient vector.  ``adam_state`` and ``load_adam_state`` read
and set Adam's moments by parameter name in either layout; ``split`` cuts a
vector of the flat layout into those names.  Imports torch and numpy
only, so that ``training/checkpoint.py``, ``training/trainer.py`` and
``utils/jax_checkpoint.py`` all sit above it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


def split(vec: torch.Tensor, names: Sequence[str], shapes: Sequence[torch.Size]) -> Dict[str, torch.Tensor]:
    """A vector of the flat layout (the parameters ``names`` of ``shapes``,
    raveled one after another) as {name: view in its shape}."""
    bounds = np.cumsum([0] + [int(np.prod(s)) for s in shapes]).tolist()
    if vec.numel() != bounds[-1]:
        raise ValueError(f"a flat vector of {vec.numel()} values; the parameters hold {bounds[-1]}")
    flat = vec.reshape(-1)
    return {k: flat[a:b].view(s) for k, s, a, b in zip(names, shapes, bounds, bounds[1:])}


class FlatParameters:
    """Every parameter of ``model`` as a view into one f32 vector, in the
    order of ``named_parameters()``, and its ``.grad`` as a view into one
    f32 gradient vector.  ``param``, an ``nn.Parameter`` on the vector's
    storage with ``grad`` as its gradient, is what Adam holds."""

    def __init__(self, model: torch.nn.Module):
        named = list(model.named_parameters())
        if {p.dtype for _, p in named} != {torch.float32} or len({p.device for _, p in named}) != 1:
            raise ValueError("flat_optimizer needs f32 parameters on one device")
        self.names = [k for k, _ in named]
        self.shapes = [p.shape for _, p in named]
        self.params = [p for _, p in named]
        flat = torch.empty(sum(p.numel() for p in self.params), dtype=torch.float32, device=named[0][1].device)
        self.grad = torch.zeros_like(flat)
        views = self.split(flat)
        self.grads: List[torch.Tensor] = list(self.split(self.grad).values())
        with torch.no_grad():
            for k, p in zip(self.names, self.params):
                views[k].copy_(p)
                p.data = views[k]
        self.param = torch.nn.Parameter(flat)
        self.zero_grad()

    def zero_grad(self) -> None:
        """Zero the gradient vector in place and bind every ``.grad`` to its
        slice again, should anything have set one to None."""
        self.grad.zero_()
        self.param.grad = self.grad
        for p, g in zip(self.params, self.grads):
            if p.grad is not g:
                p.grad = g

    def split(self, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A vector of the flat layout as {parameter name: view in its shape}."""
        return split(vec, self.names, self.shapes)


def adam_state(state) -> Dict[str, Optional[Dict[str, torch.Tensor]]]:
    """{parameter name: Adam's ``step``, ``exp_avg`` and ``exp_avg_sq`` for
    it, or None where Adam holds none} of a ``TrainState``, in either
    layout (flat: views into the vectors)."""
    opt = state.optimizer
    if state.flat is None:
        return {k: (dict(opt.state[p]) if opt.state.get(p) else None) for k, p in state.model.named_parameters()}
    st = opt.state.get(state.flat.param)
    if not st:
        return dict.fromkeys(state.flat.names)
    mu, nu = state.flat.split(st["exp_avg"]), state.flat.split(st["exp_avg_sq"])
    return {k: {"step": st["step"], "exp_avg": mu[k], "exp_avg_sq": nu[k]} for k in state.flat.names}


def load_adam_state(state, moments: Dict[str, Any], step: int) -> None:
    """Set Adam's state of a ``TrainState`` to ``moments`` ({parameter
    name: (exp_avg, exp_avg_sq)} in the port's layout, every parameter),
    each at Adam's step ``step``, in the optimizer's own layout (per leaf
    or flat)."""
    opt_sd = state.optimizer.state_dict()
    count = torch.tensor(float(step))
    if state.flat is None:
        index = {}
        for group_sd, group in zip(opt_sd["param_groups"], state.optimizer.param_groups):
            for i, p in zip(group_sd["params"], group["params"]):
                index[id(p)] = i
        opt_sd["state"] = {index[id(p)]: {"step": count.clone(), "exp_avg": moments[k][0], "exp_avg_sq": moments[k][1]}
                           for k, p in state.model.named_parameters()}
    else:
        names = state.flat.names
        opt_sd["state"] = {opt_sd["param_groups"][0]["params"][0]: {
            "step": count, "exp_avg": torch.cat([moments[k][0].reshape(-1) for k in names]),
            "exp_avg_sq": torch.cat([moments[k][1].reshape(-1) for k in names])}}
    state.optimizer.load_state_dict(opt_sd)
