"""One whole train step of the port against the JAX package's
``make_train_step``, in the exact f32 config with the pose, cycle and SSIM
losses, from the same weights (``utils/convert.py``) and the same batch,
for each of five batches (seeds 0-4).

After one Adam step the first moment is 0.1 x the clipped gradient on both
sides, so the per-leaf gradients are compared through it.  Tolerances,
each with the largest reading over the five batches:
  - the image, SSIM and cycle losses, the attention entropy, and the total
    less the pose term: 1e-4 relative (3.8e-6);
  - the pose loss: 1e-3 relative (3.3e-4).  At random weights the pose
    head's cross block amplifies small differences of its inputs: on the
    same inputs it matches JAX (``test_torch_modules.py``), but the f32
    round-off by which the two sides' UFC outputs differ (sums in another
    order) leaves it many times larger;
  - the pre-clip ``grad_norm``: 1e-2 relative (6.6e-3).  The JAX step's K4
    rounds the cotangents to bf16 (``bilinear_sample.py:444-447``), so the
    gradients of the leaves below the samplers agree only to bf16 level;
    the pose head's leaves agree in norm to 8.2e-4;
  - per-leaf gradient cosine >= 0.99 (lowest 0.9970);
  - the parameter updates: Adam's first step is about lr * sign(g), so the
    updates agree except where a tiny gradient entry flips sign: the mean
    |update difference| is held below 1 % of lr (0.39 %), and no update
    exceeds lr;
  - the BatchNorm running statistics: 1e-4 of the leaf's max (7.8e-6).
"""

import pytest
import torch

from torch_step_helpers import (
    IMG,
    check_exact_gradients,
    check_exact_losses_and_grad_norm,
    check_exact_updates_and_bn_stats,
    run_both,
)

torch.set_num_threads(2)

MODEL = dict(mask_upsample=IMG, npoints=8, ufc_layer_nums=(1, 1, 1))
LOSS = dict(pose=True, cycle=True, ssim=True)


@pytest.fixture(scope="module", params=range(5), ids=lambda seed: f"seed{seed}")
def steps(request):
    return run_both(MODEL, LOSS, seed=request.param)


def test_exact_step_losses_and_grad_norm_match_jax(steps):
    _, _, jm, tstate, tm = steps
    check_exact_losses_and_grad_norm(jm, tm, tstate)


def test_exact_step_gradients_match_jax_leaf_by_leaf(steps):
    _, jax_after, _, tstate, _ = steps
    check_exact_gradients(jax_after, tstate)


def test_exact_step_updates_params_and_bn_stats_like_jax(steps):
    before, jax_after, _, tstate, _ = steps
    check_exact_updates_and_bn_stats(before, jax_after, tstate)
