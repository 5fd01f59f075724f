"""The pose term's gradient in the fast (bf16) config against the JAX
package's, through the encoder and the UFC.

At random weights the pose head's cross block amplifies differences on its
input tokens, so a whole-step comparison of the pose term in bf16 compares
two different Jacobians of the head (``test_torch_train_fast.py``).  Here one cotangent, the port's pose-loss
gradient on the tokens, is pulled back through the bf16 encode on both
sides, from the same weights and batch, for each of five batches (seeds
0-4).  The head itself computes in f32 and is held to JAX in
``test_torch_train_exact.py``.

Tolerances, each with the largest reading over the five batches:
  - the tokens: max |port - JAX| below 3e-2 of the max (1.4e-2: bf16);
  - the global norm of the gradient over the encoder and UFC leaves:
    1e-2 relative (2.1e-3);
  - per-leaf cosine: the median >= 0.999 (lowest 0.99988), every leaf
    >= 0.8 (lowest 0.858, biases of the UFC's 4-D convolutions);
  - leaves the tokens do not reach are zero on both sides.
"""

import numpy as np
import pytest
import torch

from torch_step_helpers import IMG, pose_term_encode_grads

torch.set_num_threads(2)

MODEL = dict(mask_upsample=IMG, npoints=8, ufc_layer_nums=(1, 1, 1), fast_sampling=True, compute_dtype="bfloat16")


@pytest.mark.parametrize("seed", range(5), ids=lambda seed: f"seed{seed}")
def test_fast_pose_term_gradient_through_encode_matches_jax(seed):
    grads, token_err = pose_term_encode_grads(MODEL, seed)
    assert token_err < 3e-2
    cos = {}
    for key, (got, ref) in grads.items():
        denom = np.linalg.norm(got) * np.linalg.norm(ref)
        if denom == 0:
            assert np.abs(got).max() == 0 and np.abs(ref).max() == 0, key
            continue
        cos[key] = float((got * ref).sum() / denom)
    assert len(cos) > 300
    port_norm, jax_norm = (np.sqrt(sum(float((g[i].astype(np.float64) ** 2).sum()) for g in grads.values()))
                           for i in (0, 1))
    assert abs(port_norm - jax_norm) <= 1e-2 * jax_norm, (port_norm, jax_norm)
    assert np.median(list(cos.values())) >= 0.999
    assert min(cos.values()) >= 0.8, min(cos.items(), key=lambda kv: kv[1])
