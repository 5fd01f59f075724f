"""One whole train step of the port against the JAX package's
``make_train_step`` in the fast config (bf16, ``fast_sampling``: K1 forward
and K4 backward on the <=64^2 levels, ``convmap_sample_pair`` on the 256^2
one, K2 forward, UFC remat), from the same weights and batch, for each of
five batches (seeds 0-4).

The pose loss is off here.  At random weights the pose head's cross block
amplifies differences on its input tokens, so the bf16-level (1 %)
differences between the port's and JAX's tokens give the head a different
Jacobian on each side, and the pose term's gradient through the network
differs by factors.  ``test_torch_train_pose.py`` compares that gradient in this
config from one shared cotangent on the tokens; the head itself computes
in f32 in both configs and is held to JAX in ``test_torch_train_exact.py``.

Tolerances, bf16 level, each with the largest reading over the five
batches: each loss term 2e-2 relative (5.6e-3); the pre-clip
``grad_norm`` 2e-2 relative (1.3e-2); per-leaf gradient cosine (through
Adam's first moment) >= 0.9 for every leaf (lowest 0.933) and >= 0.99 for
the median (lowest 0.9968): bf16 UFC volumes are rounded at different
points by XLA and by eager PyTorch; the mean |update difference| below
5 % of lr (1.4 %); the BatchNorm running statistics (the encoder computes
in f32) 1e-4 of the max (7.3e-6).
"""

import numpy as np
import pytest
import torch

from torch_step_helpers import IMG, LR, gradient_cosines, run_both, update_and_stats_errors

torch.set_num_threads(2)

MODEL = dict(mask_upsample=IMG, npoints=8, ufc_layer_nums=(1, 1, 1), fast_sampling=True, compute_dtype="bfloat16")
LOSS = dict(cycle=True, ssim=True)


@pytest.fixture(scope="module", params=range(5), ids=lambda seed: f"seed{seed}")
def steps(request):
    return run_both(MODEL, LOSS, seed=request.param)


def test_fast_step_losses_and_grad_norm_match_jax(steps):
    _, _, jm, tstate, tm = steps
    assert set(tm) == set(jm) == {"img_loss", "ssim_loss", "cycle_loss", "total_train_loss",
                                  "total_at_entropy", "grad_norm"}
    for k in tm:
        assert abs(tm[k] - jm[k]) <= 2e-2 * abs(jm[k]), (k, tm[k], jm[k])
    assert tstate.step == tstate.updates == 1


def test_fast_step_gradients_match_jax_leaf_by_leaf(steps):
    _, jax_after, _, tstate, _ = steps
    cos = gradient_cosines(jax_after, tstate)
    assert len(cos) > 300
    assert min(cos.values()) >= 0.9, min(cos.items(), key=lambda kv: kv[1])
    assert np.median(list(cos.values())) >= 0.99


def test_fast_step_updates_params_and_bn_stats_like_jax(steps):
    before, jax_after, _, tstate, _ = steps
    mean_diff, biggest, bn = update_and_stats_errors(before, jax_after, tstate)
    assert biggest <= 1.001 * LR
    assert mean_diff < 0.05 * LR
    assert max(bn.values()) <= 1e-4, max(bn.items(), key=lambda kv: kv[1])
