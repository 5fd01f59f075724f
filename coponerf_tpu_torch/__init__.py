"""CoPoNeRF in PyTorch with hand-written Hopper (sm_90a) CUDA kernels.

The port of the JAX package ``coponerf_tpu`` (which stays the reference):
the inference path, ``encode`` once per stereo pair and ``render`` per ray
chunk, with the same module names, layouts and token orders.

Layout:
  geometry/  camera / Plucker / epipolar math (f32)
  ops/       resize, correlation, exact grid sampling, and the three kernel
             modules (bilinear_sample K1, split_matmul K2, weighted_sum K3)
             with their plain versions; ``_build`` compiles ``csrc/``
  models/    ResNet-34 encoder, UFC aggregation, pose head, light-field
             decoder, the CoPoNeRF top module
  utils/     JAX-params converter and the seeded parameter fill
  csrc/      CUDA sources of the kernels
  config     ``ModelConfig``
  data/      synthetic stereo scenes (``make_batch``)

The port imports no JAX.  ``config`` and ``data.synthetic`` re-export the
reference package's framework-free ``ModelConfig`` dataclass and numpy
``make_batch``, so users of the port import only this package.
"""

__version__ = "0.1.0"
