"""LPIPS with the VGG16 backbone, as a ``torch.nn.Module``.

The port of ``coponerf_tpu/eval/lpips_jax.py``.  The reference evaluates
LPIPS with the ``lpips`` package's VGG variant (test.py:149, 258-263),
which needs pretrained VGG16 and linear-head weights.  They are read from
the same converted ``.npz`` as the JAX package reads: conv kernels
``features_{i}/kernel`` (HWIO) and ``features_{i}/bias`` for torchvision's
VGG16 feature indices ``CONV_IDX``, head kernels ``lin{k}/kernel`` of shape
(1, 1, C_k, 1).  ``convert_torch_lpips`` writes that file from a torch
LPIPS state dict and a torchvision VGG16 state dict;
``make_random_weights`` writes a structurally valid file of random weights
(offline runs and tests: it is not the reference metric).

The 13 convolutions run as ``F.conv2d`` (cuDNN on a card), in f32 with TF32
off whatever the global flags say, so the card and the CPU give the same
metric to f32 round-off.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# torchvision VGG16 .features conv layer indices; LPIPS taps relu1_2,
# relu2_2, relu3_3, relu4_3 and relu5_3, the last conv of each block
CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
PER_BLOCK = [2, 2, 3, 3, 3]
CHANNELS = [64, 128, 256, 512, 512]

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def make_random_weights(path: str, seed: int = 0) -> str:
    """Write a random-weight npz of the LPIPS layout (the JAX package's
    ``make_random_weights``: the same draws from the same seed)."""
    rng = np.random.RandomState(seed)
    out = {}
    in_ch = 3
    chans = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    for i, c in zip(CONV_IDX, chans):
        out[f"features_{i}/kernel"] = (rng.randn(3, 3, in_ch, c) * 0.05).astype(np.float32)
        out[f"features_{i}/bias"] = np.zeros(c, np.float32)
        in_ch = c
    for k, c in enumerate(CHANNELS):
        out[f"lin{k}/kernel"] = np.abs(rng.randn(1, 1, c, 1)).astype(np.float32) * 0.1
    np.savez(path, **out)
    return path


def convert_torch_lpips(lpips_state: dict, vgg_state: dict, out_path: str) -> None:
    """Write the npz from torch state dicts: the lpips package's lin heads
    (``lin{k}.model.1.weight``) and torchvision VGG16's ``features.{i}``."""
    out = {}
    for i in CONV_IDX:
        w = np.asarray(vgg_state[f"features.{i}.weight"])
        out[f"features_{i}/kernel"] = np.transpose(w, (2, 3, 1, 0))
        out[f"features_{i}/bias"] = np.asarray(vgg_state[f"features.{i}.bias"])
    for k in range(5):
        w = np.asarray(lpips_state[f"lin{k}.model.1.weight"])  # (1, C, 1, 1)
        out[f"lin{k}/kernel"] = np.transpose(w, (2, 3, 1, 0))
    np.savez(out_path, **out)


class LPIPSVGG(nn.Module):
    """``LPIPSVGG(path)(img1, img2)``: images (H, W, 3) or (B, H, W, 3) in
    [-1, 1] (numpy or tensors) -> the distance as a float, averaged over
    the batch as the JAX package's ``LPIPSVGG`` averages it."""

    _cache: Dict[Tuple[str, str], "LPIPSVGG"] = {}

    def __init__(self, weights_path: str):
        super().__init__()
        data = np.load(weights_path)
        self.convs = nn.ModuleList()
        for i in CONV_IDX:
            k = data[f"features_{i}/kernel"]
            conv = nn.Conv2d(k.shape[2], k.shape[3], 3, padding=1)
            conv.weight.data.copy_(torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))))
            conv.bias.data.copy_(torch.from_numpy(data[f"features_{i}/bias"]))
            self.convs.append(conv)
        for k in range(5):
            self.register_buffer(f"lin{k}", torch.from_numpy(np.ascontiguousarray(data[f"lin{k}/kernel"][0, 0, :, 0])))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1))
        self.requires_grad_(False)

    @classmethod
    def get(cls, weights_path: str, device="cpu") -> "LPIPSVGG":
        """The module for ``weights_path`` on ``device``, built once."""
        key = (weights_path, str(torch.device(device)))
        if key not in cls._cache:
            cls._cache[key] = cls(weights_path).to(device).eval()
        return cls._cache[key]

    def features(self, x: torch.Tensor):
        """x (B, 3, H, W) in [-1, 1] -> the five tap activations."""
        x = (x - self.shift) / self.scale
        taps, conv_i = [], 0
        for b, n_convs in enumerate(PER_BLOCK):
            for _ in range(n_convs):
                x = F.relu(self.convs[conv_i](x))
                conv_i += 1
            taps.append(x)
            if b < len(PER_BLOCK) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps

    def distance(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """NHWC f32 tensors on the module's device -> 0-d tensor."""
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            f1 = self.features(img1.permute(0, 3, 1, 2))
            f2 = self.features(img2.permute(0, 3, 1, 2))
        total = torch.zeros((), dtype=torch.float32, device=img1.device)
        for k, (a, b) in enumerate(zip(f1, f2)):
            na = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            nb = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            d = (na - nb) ** 2
            total = total + torch.mean(torch.einsum("bchw,c->bhw", d, getattr(self, f"lin{k}")))
        return total

    @torch.no_grad()
    def forward(self, img1, img2) -> float:
        dev = self.shift.device
        img1 = torch.as_tensor(img1, dtype=torch.float32, device=dev)
        img2 = torch.as_tensor(img2, dtype=torch.float32, device=dev)
        if img1.ndim == 3:
            img1, img2 = img1[None], img2[None]
        return float(self.distance(img1, img2))
