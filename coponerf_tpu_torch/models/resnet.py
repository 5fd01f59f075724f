"""ResNet-34 pixel-aligned spatial encoder.

Counterpart of ``coponerf_tpu/models/resnet.py``: the same block layout and
parameter names (``stem``, ``layer{s}_{b}``, ``cb1``/``cb2``/``downsample``,
``conv``/``bn``).  BatchNorm follows flax's ``nn.BatchNorm(momentum=0.9)``:
at inference it normalises with the running statistics; in training with
the batch statistics, and it updates the running ones.  Input and outputs
are NHWC; the convolutions run NCHW inside.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from coponerf_tpu_torch.parallel.mesh import all_reduce_sum, group_size

_MOMENTUM = 0.9     # flax nn.BatchNorm(momentum=0.9): weight of the old running value


class BatchNorm(nn.Module):
    """BatchNorm over (N, H, W) of NCHW f32 tensors: weight/bias plus running
    mean/var buffers.

    ``train=True`` normalises with the batch mean and the BIASED batch
    variance (flax's E[x^2] - E[x]^2, clipped at 0) and moves the running
    statistics as ``0.9 * old + 0.1 * batch``, the biased variance included
    (``F.batch_norm(training=True)`` would store the unbiased one and drift
    from the JAX package after the first step).

    ``stats_group`` (set by ``parallel.mesh.attach_batch_norm``; None: the
    local batch) is the process group whose ranks' batches make up the
    global batch.  Each holds an equal share of it, so the global mean and
    mean square are the averages of the ranks' (one differentiable
    all-reduce a layer); the variance, the normalisation and the running
    update then follow from them as above, equal on every rank."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.eps = eps
        self.stats_group = None

    def forward(self, x, train: bool = False):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        dims = (0, 2, 3)
        mean, mean_sq = x.mean(dim=dims), (x * x).mean(dim=dims)
        if self.stats_group is not None:
            both = all_reduce_sum(torch.stack([mean, mean_sq]), self.stats_group) / group_size(self.stats_group)
            mean, mean_sq = both[0], both[1]
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            m = _MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


class ConvBN(nn.Module):
    def __init__(self, in_features: int, features: int, kernel: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel, stride, kernel // 2, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x, train: bool = False):
        return self.bn(self.conv(x), train)


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.cb1 = ConvBN(in_features, features, 3, stride)
        self.cb2 = ConvBN(features, features, 3, 1)
        if stride != 1 or in_features != features:
            self.downsample = ConvBN(in_features, features, 1, stride)
        else:
            self.downsample = None

    def forward(self, x, train: bool = False):
        out = self.cb2(torch.relu(self.cb1(x, train)), train)
        identity = x if self.downsample is None else self.downsample(x, train)
        return torch.relu(out + identity)


class ResNet34Encoder(nn.Module):
    """Returns the feature pyramid deepest first, top ``num_keep`` maps."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), widths: Sequence[int] = (64, 128, 256, 512), num_keep: int = 3):
        super().__init__()
        self.stem = ConvBN(3, 64, 7, 2)
        self.names = []
        cin = 64
        for stage, (n_blocks, width) in enumerate(zip(layers, widths)):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, BasicBlock(cin, width, stride))
                blocks.append(name)
                cin = width
            self.names.append(blocks)
        self.num_keep = num_keep

    def forward(self, x: torch.Tensor, train: bool = False):
        """x: (B, H, W, 3) ImageNet-normalized -> NHWC maps, deepest first.
        Computes in f32 (flax's promotion of a bf16 input with f32 params);
        ``train`` selects the batch statistics in every BatchNorm."""
        x = x.float().permute(0, 3, 1, 2)
        x = torch.relu(self.stem(x, train))
        latents = [x]
        for blocks in self.names:
            for name in blocks:
                x = getattr(self, name)(x, train)
            latents.append(x)
        latents = latents[::-1][: self.num_keep]
        return [z.permute(0, 2, 3, 1) for z in latents]
