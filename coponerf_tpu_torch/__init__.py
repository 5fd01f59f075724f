"""CoPoNeRF in PyTorch with hand-written Hopper (sm_90a) CUDA kernels.

The port of the JAX package ``coponerf_tpu`` (which stays the reference):
``encode`` once per stereo pair and ``render`` per ray chunk, in inference
and in training, with the same module names, layouts and token orders, plus
the losses, an Adam trainer with in-training validation, checkpoints (and
the import of the reference's ``.pth`` weights), the evaluation harness
with LPIPS and image summaries, camera-path rendering, data-parallel
training and the ray-sharded render over ``torch.distributed``, and the
``python -m coponerf_tpu_torch.train``, ``python -m coponerf_tpu_torch.test`` and
``python -m coponerf_tpu_torch.render_path`` entry points.

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
  training/  losses, the train step and loop, checkpoints, validation,
             image summaries (numpy drawing)
  eval/      the chunked-render evaluation harness, metrics, LPIPS-VGG,
             overlap table, camera-path rendering
  parallel/  process meshes, batch shards and the collectives of
             data-parallel training (mesh), the ray-sharded render,
             spawning the ranks of one machine (launch)
  utils/     JAX-params converter, the reference .pth import, the seeded
             parameter fill, the CLI parser, a zlib PNG writer
  csrc/      CUDA sources of the kernels
  config     ``ModelConfig``, ``LossConfig``, ``TrainConfig``, ``Config``
  data/      synthetic stereo scenes (``make_batch``), the RealEstate10K /
             ACID scene readers, the camera-path dataset, the native
             scene cache (ctypes over runtime/scenecache.cpp) and the
             prefetching loader
  train      the training entry point
  test       the evaluation entry point
  render_path  the camera-path entry point

The port imports neither JAX nor the JAX package: its configuration,
synthetic data, scene readers, loader and metrics are its own copies of the
JAX package's (held equal by ``tests/test_torch_config_data.py`` and
``tests/test_torch_eval_data.py``).
"""

__version__ = "0.1.0"
