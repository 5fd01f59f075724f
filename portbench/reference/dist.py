"""The reference's train step over the ranks of a process group, each rank
holding an equal share of the global batch: ``train.py``'s step on the
concatenated batch, in the form the port's mesh step takes
(``coponerf_tpu_torch/parallel/mesh.py``, written here anew from its
description):
  - BatchNorm takes its training statistics over every rank: the ranks'
    means and mean squares are averaged by a differentiable all-reduce
    (``global_batch_norm``);
  - the masked means of the losses divide by the global mask sums and are
    scaled by the number of ranks, so that the ranks' average is the
    global batch's term (``lf_loss``);
  - the gradients are averaged over the ranks before the norm, the clip and
    Adam, so every rank takes the same update (``train_steps``).
Run on one process of a group whose default group spans the ranks.  It
imports nothing of the port, of the JAX package or of JAX.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from portbench.reference import flow as flow_ops
from portbench.reference import losses as L
from portbench.reference.config import LossConfig
from portbench.reference.geometry import geodesic_rotation_distance
from portbench.reference.models.resnet import _MOMENTUM, BatchNorm


class _SumOverRanks(torch.autograd.Function):
    """The sum over the ranks; each rank's cotangent is the sum of every rank's."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def _bn_forward(self, x, train: bool = False):
    """``BatchNorm.forward`` with the statistics of the global batch."""
    if not train:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
    dims = (0, 2, 3)
    both = _SumOverRanks.apply(torch.stack([x.mean(dim=dims), (x * x).mean(dim=dims)])) / dist.get_world_size()
    mean, mean_sq = both[0], both[1]
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    with torch.no_grad():
        self.running_mean.copy_(_MOMENTUM * self.running_mean + (1.0 - _MOMENTUM) * mean)
        self.running_var.copy_(_MOMENTUM * self.running_var + (1.0 - _MOMENTUM) * var)
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var + self.eps) * self.weight
    return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


def global_batch_norm(model: torch.nn.Module) -> torch.nn.Module:
    """Give every BatchNorm of ``model`` the global batch's statistics (in place)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.forward = functools.partial(_bn_forward, m)
    return model


def _global_sum(x: torch.Tensor) -> torch.Tensor:
    x = x.detach().clone()
    dist.all_reduce(x)
    return x


def _ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    win = L.gaussian_window(window_size, device=img1.device)
    mu1 = L._depthwise_conv2d(img1, win)
    mu2 = L._depthwise_conv2d(img2, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = L._depthwise_conv2d(img1 * img1, win) - mu1_sq
    sigma2_sq = L._depthwise_conv2d(img2 * img2, win) - mu2_sq
    sigma12 = L._depthwise_conv2d(img1 * img2, win) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))


def lf_loss(cfg: LossConfig, model_input: Dict, model_out: Dict, gt: Dict) -> Dict[str, torch.Tensor]:
    """This rank's terms: their average over the ranks is ``losses.lf_loss``
    of the global batch."""
    n = dist.get_world_size()
    losses: Dict[str, torch.Tensor] = {"img_loss": L.image_loss(model_out, gt)}
    if cfg.ssim:
        flow_f, flow_b = model_out["flow"][0], model_out["flow"][1]
        ctx_rgb = model_input["context"]["rgb"]
        out_size = ctx_rgb.shape[2]
        im0 = ctx_rgb[:, 0].permute(0, 3, 1, 2)
        im1 = ctx_rgb[:, 1].permute(0, 3, 1, 2)
        w1, w0, mask_f, mask_b = flow_ops.ssim_warp_packed(im0, im1, flow_f, flow_b, out_size=out_size,
                                                           scale=out_size / flow_f.shape[-2])
        terms = []
        for a, b, m in ((w1, im0, mask_f), (w0, im1, mask_b)):
            m = m[:, None].to(im0.dtype)
            terms.append(torch.sum((1.0 - _ssim_map(a, b)) * m) / _global_sum(torch.sum(m)) / 3.0 * n)
        losses["ssim_loss"] = cfg.w_ssim * (terms[0] + terms[1]) / 2.0
    if cfg.cycle:
        pred, targ = model_out["T_to_C1_pts"], model_out["C2_pts_to_C1"]
        err = torch.linalg.vector_norm(pred - targ, dim=-1, keepdim=True)
        m = ((err.detach() <= 20.0).to(pred.dtype) * model_out["mask_c2"][..., None].to(pred.dtype)
             * model_out["matchability_cycle_mask"][..., None].to(pred.dtype))
        den = _global_sum(torch.sum(m)) + 1e-6
        losses["cycle_loss"] = cfg.w_cycle * (torch.sum(L.huber(pred, targ) * m) / den * n)
    if cfg.pose:
        rot = torch.mean(geodesic_rotation_distance(model_out["rel_pose"][:, :3, :3],
                                                    model_out["gt_rel_pose"][:, :3, :3], eps=1e-7))
        gap = model_out["rel_pose"][:, :3, 3] - model_out["gt_rel_pose"][:, :3, 3]
        trans = torch.mean(torch.linalg.vector_norm(gap, dim=-1))
        losses["pose_loss"] = cfg.w_pose * (rot + trans)
    return losses


def train_steps(model: torch.nn.Module, batches: List[Dict], loss_cfg: LossConfig, lr: float,
                max_norm: float) -> Tuple[Tuple[List[float], List[Dict[str, float]]], Dict[str, float], Dict[str, float]]:
    """``reference.train.train_steps`` of the global batches whose shares
    ``batches`` are, from rank 0's weights, ``model``'s BatchNorms under
    ``global_batch_norm``.  Returns the same readings, each loss and term
    the global batch's."""
    n = dist.get_world_size()
    named = list(model.named_parameters())
    params = [p for _, p in named]
    with torch.no_grad():
        for t in (*params, *model.buffers()):
            dist.broadcast(t, src=0)
    start = {k: p.detach().clone() for k, p in named}
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
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat.div_(n)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        del flat
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        if float(norm) >= max_norm:
            for g in grads:
                g.div_(norm).mul_(max_norm)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if s == 0:
            grad1 = {k: float(p.grad.norm()) for k, p in named}
        opt.step()
        values = torch.stack([total.detach(), *(v.detach() for v in parts.values())])
        dist.all_reduce(values)
        values = (values / n).tolist()
        losses.append(values[0])
        terms.append(dict(zip(parts, values[1:])))
        terms[-1]["grad_norm"] = float(norm)
    change = {k: float((p.detach() - start[k]).norm()) for k, p in named}
    return (losses, terms), grad1, change
