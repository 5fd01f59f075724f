"""The reference's train step: forward, the losses, autograd's backward,
global-norm clipping in optax's form (``g / norm * max_norm`` when ``norm >=
max_norm``) and Adam (b1 0.9, b2 0.999, eps 1e-8) over every parameter, a
parameter that no loss reaches taking a zero gradient."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference.config import LossConfig
from portbench.reference.losses import lf_loss


def train_steps(model: torch.nn.Module, batches: List[Dict], loss_cfg: LossConfig, lr: float,
                max_norm: float) -> Tuple[Tuple[List[float], List[Dict[str, float]]], Dict[str, float], Dict[str, float]]:
    """One step on each of ``batches`` from ``model``'s weights.  Returns
    (each step's total loss, each step's loss terms), each parameter's first
    gradient norm as Adam gets it (after clipping), and each parameter's
    change norm after the last step."""
    named = list(model.named_parameters())
    params = [p for _, p in named]
    start = {n: p.detach().clone() for n, p in named}
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses, terms, grad1 = [], [], {}
    for s, batch in enumerate(batches):
        out = model(batch, val=False, train=True)
        parts = lf_loss(loss_cfg, batch, out, batch["query"])
        total = sum(parts.values())
        opt.zero_grad(set_to_none=True)
        total.backward()
        del out
        grads = [p.grad for p in params if p.grad is not None]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        if float(norm) >= max_norm:
            for g in grads:
                g.div_(norm).mul_(max_norm)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if s == 0:
            grad1 = {n: float(p.grad.norm()) for n, p in named}
        opt.step()
        losses.append(float(total.detach()))
        terms.append({k: float(v.detach()) for k, v in parts.items()})
        terms[-1]["grad_norm"] = float(norm)
    change = {n: float((p.detach() - start[n]).norm()) for n, p in named}
    return (losses, terms), grad1, change
