"""The reference's configuration: the port's ``ModelConfig`` and
``LossConfig`` fields with the same names and defaults, so that a cell's
configuration file builds both.  The fields that pick a kernel
(``fused_argmax``, ``ufc_scan``, ``train_onehot_small``,
``convmap_direct_grad``) are accepted and change nothing the reference
computes; ``conv4d_impl`` and ``remat_policy`` pick the copied UFC's
formulation of the same math.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    n_view: int = 2
    npoints: int = 64               # epipolar samples per ray
    num_hidden_units_phi: int = 128
    latent_dim: int = 832           # 3*256 (UFC) + 64 (conv_map)
    hidden_dim: int = 128           # attention key/query width
    repeat_attention: bool = True
    corr_heads: int = 8
    ufc_layer_nums: Tuple[int, ...] = (2, 2, 1)
    mask_upsample: int = 256        # cyclic-consistency mask resolution
    # "float32" or "bfloat16": the encoder/UFC volumes, the sampled latents
    # and W1 run in it; geometry and the attention logits stay f32
    compute_dtype: str = "float32"
    # throughput path: the K1 sampler on every level, sample-major tokens
    # and coarse-to-fine sampling in inference
    fast_sampling: bool = False
    # recompute each UFC layer in the backward (torch.utils.checkpoint)
    remat_ufc: bool = True
    # Conv4d branches: "2d" folds the untouched pair into a conv2d batch
    # (four permute copies a call); "3d" runs each as one conv3d on the
    # flattened layout, the untouched pair a kernel-1 axis (no copies)
    conv4d_impl: str = "2d"
    # with remat_ufc: "full" recomputes the whole layer in the backward;
    # "dots" keeps its mm/bmm outputs and recomputes the rest
    remat_policy: str = "full"
    # two-stage coarse-to-fine sampling (inference under fast_sampling);
    # 0/0 = one uniform stage of npoints
    coarse_samples: int = 0
    fine_samples: int = 0
    # training: sample the 256^2 conv_map level through convmap_sample_pair,
    # whose backward goes straight to the 7x7 conv kernel
    convmap_direct_grad: bool = True
    # fast training: the <=64^2 levels go through K1 forward and K4 backward
    train_onehot_small: bool = True
    # the JAX package's lax.scan over each UFC stage's layers: here only the
    # layout of the .npz the port writes (the modules keep the loop layout;
    # the math is the same)
    ufc_scan: bool = False
    fused_argmax: Optional[bool] = None

    def __post_init__(self):
        if self.conv4d_impl not in ("2d", "3d"):
            raise ValueError(f"conv4d_impl must be '2d' or '3d', not {self.conv4d_impl!r}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', not {self.remat_policy!r}")


@dataclasses.dataclass(frozen=True)
class LossConfig:
    pose: bool = False
    cycle: bool = False
    ssim: bool = False
    w_cycle: float = 0.01
    w_ssim: float = 1.0
    w_pose: float = 1.0


__all__ = ["LossConfig", "ModelConfig"]
