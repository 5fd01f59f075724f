"""CoPoNeRF in PyTorch with hand-written Hopper (sm_90a) CUDA kernels.

The port of the JAX package ``coponerf_tpu`` (which stays the reference):
``encode`` once per stereo pair and ``render`` per ray chunk, in inference
and in training, with the same module names, layouts and token orders, plus
the losses, an Adam trainer, checkpoints and the ``python -m
coponerf_tpu_torch.train`` entry point.

Layout:
  geometry/  camera / Plucker / epipolar math (f32)
  ops/       resize, correlation, exact grid sampling, the conv_map sampler
             with its direct backward, and the kernel modules
             (bilinear_sample: K1, its corner-id entry and K4;
             split_matmul K2; weighted_sum K3) with their plain versions;
             ``_build`` compiles ``csrc/``
  models/    ResNet-34 encoder, UFC aggregation, pose head, light-field
             decoder, the CoPoNeRF top module
  training/  losses, the train step and loop, checkpoints
  utils/     JAX-params converter and the seeded parameter fill
  csrc/      CUDA sources of the kernels
  config     ``ModelConfig``, ``LossConfig``, ``TrainConfig``, ``Config``
  data/      synthetic stereo scenes (``make_batch``)
  train      the training entry point

The port imports neither JAX nor the JAX package: its configuration and
synthetic data are its own copies of the JAX package's (held equal by
``tests/test_torch_config_data.py``).
"""

__version__ = "0.1.0"
