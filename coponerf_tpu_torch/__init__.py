"""CoPoNeRF in PyTorch with hand-written Hopper (sm_90a) CUDA kernels.

The port of the JAX package ``coponerf_tpu`` (which stays the reference):
``encode`` once per stereo pair and ``render`` per ray chunk, in inference
and in training, with the same module names, layouts and token orders, plus
the losses, an Adam trainer, checkpoints, the evaluation harness and the
``python -m coponerf_tpu_torch.train`` and ``python -m
coponerf_tpu_torch.test`` entry points.

Layout:
  geometry/  camera / Plucker / epipolar math (f32)
  ops/       resize, correlation, exact grid sampling, the conv_map sampler
             with its direct backward, and the kernel modules
             (bilinear_sample: K1, its corner-id entry, the multi-level
             entry K8 and K4;
             split_matmul K2; weighted_sum K3) with their plain versions;
             ``_build`` compiles ``csrc/``
  models/    ResNet-34 encoder, UFC aggregation, pose head, light-field
             decoder, the CoPoNeRF top module
  training/  losses, the train step and loop, checkpoints
  eval/      the chunked-render evaluation harness, metrics, overlap table
  utils/     JAX-params converter, the seeded parameter fill, the CLI parser
  csrc/      CUDA sources of the kernels
  config     ``ModelConfig``, ``LossConfig``, ``TrainConfig``, ``Config``
  data/      synthetic stereo scenes (``make_batch``), the RealEstate10K /
             ACID scene readers and the prefetching loader
  train      the training entry point
  test       the evaluation entry point

The port imports neither JAX nor the JAX package: its configuration,
synthetic data, scene readers, loader and metrics are its own copies of the
JAX package's (held equal by ``tests/test_torch_config_data.py`` and
``tests/test_torch_eval_data.py``).
"""

__version__ = "0.1.0"
