"""Configuration of the port: model, loss and training options.

The fields of ``coponerf_tpu/config.py`` that the port reads, copied with
the same names and defaults, so the same keyword arguments build the same
configuration in both packages (``tests/test_torch_config_data.py`` holds
them equal).  ``fused_argmax`` (None = OFF, as in the JAX package) makes
the UFC extract both flows through the fused soft-argmax K5.

The train step's formulations, each off by default as in the JAX package:
``conv4d_impl="3d"`` runs each Conv4d branch as one ``conv3d`` on the
flattened volume; ``remat_policy="dots"`` keeps the UFC layers' matrix
products through the recompute of ``remat_ufc``; ``ufc_scan`` writes the
JAX package's scan layout of the UFC into its ``.npz``; ``flat_optimizer``
runs Adam over one vector of every parameter.  A value outside
``conv4d_impl``'s or ``remat_policy``'s two raises ``ValueError``.
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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 5e-5 * 4
    lr_decay: float = 0.95          # per-epoch staircase decay
    clip_grad_norm: float = 1.0
    steps_til_summary: int = 500
    epochs_til_ckpt: int = 100
    iters_til_ckpt: int = 10000
    seed: int = 0
    # dataloader steps per epoch; 0 = unknown, the decay then steps every
    # steps_til_summary (synthetic runs only)
    steps_per_epoch: int = 0
    # the process mesh of data-parallel training (parallel/mesh.py make_mesh):
    # one -1 takes the ranks the others leave; axes "data" and "rays"
    # Adam over one f32 vector holding every parameter (optax.flatten): the
    # parameters and gradients become views into two flat buffers, and the
    # norm, finite check, clip and all-reduce each act on the one gradient
    flat_optimizer: bool = False
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)
    # raise at the first NaN of a step instead of skipping the step
    # (training/trainer.py nan_checks); debugging only
    debug_nans: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    logging_root: str = "logs"
    experiment_name: str = "default"


__all__ = ["Config", "LossConfig", "ModelConfig", "TrainConfig"]
