"""The exact path's table gradient, held to plain autograd.

``grid_sample_tablegrad`` differentiates the exact f32 gather by K4 (on the
CPU its plain version: an f32 ``index_add_`` of the weighted cotangents over
the corner ids of ``bilinear_corner_decomposition``).  JAX's exact path
rounds that gradient to bf16 inside its K4, so the tests against JAX hold
the port only at 1e-2 (``test_torch_train_ops.py``).  Here the same gradient
is held to PyTorch's own autograd through the port's f32 ``grid_sample``,
which needs no kernel: both sum the same f32 products w * g into each table
cell, in another order, so they agree to f32 round-off.  The bound, 1e-5 of
the largest gradient magnitude elementwise, leaves that round-off (a cell
sums up to a few hundred terms here) two orders of magnitude of room; a
missing, doubled or misplaced corner moves a cell by a whole term.
"""

import numpy as np
import pytest
import torch

from coponerf_tpu_torch.ops.bilinear_sample import grid_sample_tablegrad, onehot_transpose_matmul
from coponerf_tpu_torch.ops.grid_sample import grid_sample

REL = 1e-5


def _points(rng, B, P):
    """[-1, 1] points, a third of them spread up to 0.6 past each edge."""
    pts = rng.uniform(-1.0, 1.0, (B, P, 2)).astype(np.float32)
    off = rng.random((B, P)) < 1 / 3
    pts[off] = rng.uniform(-1.6, 1.6, (int(off.sum()), 2)).astype(np.float32)
    return pts


@pytest.mark.parametrize("mode", ["border", "zeros"])
@pytest.mark.parametrize("B, H, W, C, P", [(2, 9, 13, 8, 700), (1, 16, 16, 32, 3000)])
def test_tablegrad_matches_autograd_of_exact_gather(mode, B, H, W, C, P):
    rng = np.random.default_rng(H * 100 + P)
    image = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32))
    grid = torch.from_numpy(_points(rng, B, P)).reshape(B, P // 10, 10, 2)
    cot = torch.from_numpy(rng.standard_normal((B, P // 10, 10, C)).astype(np.float32))

    ref_img = image.clone().requires_grad_(True)
    ref_out = grid_sample(ref_img, grid, mode)
    (ref_out * cot).sum().backward()

    img = image.clone().requires_grad_(True)
    before = onehot_transpose_matmul.launches
    out = grid_sample_tablegrad(img, grid, mode)
    (out * cot).sum().backward()

    assert onehot_transpose_matmul.launches == before   # CPU tensors: the plain version
    assert torch.equal(out, ref_out)                     # the same forward, bit for bit
    assert img.grad.dtype == torch.float32 and img.grad.shape == image.shape
    top = ref_img.grad.abs().max().item()
    assert top > 0
    err = (img.grad - ref_img.grad).abs().max().item()
    assert err <= REL * top, (err, top)
    assert torch.equal(img.grad == 0, ref_img.grad == 0)   # the same cells untouched
