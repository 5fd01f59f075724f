"""K5, the fused dual-axis soft-argmax (``coponerf_tpu_torch/ops/soft_argmax.py``).

On the CPU the wrappers run their plain versions.  The port's
``soft_argmax_both`` is held to the JAX package's (Pallas interpreted on the
CPU, as ``tests/test_pallas_kernels.py`` runs it) in values at atol 1e-5
and in the gradients of one ``sin``/square loss at atol 1e-4, on a
``randn * 3`` volume and a cosine-like one; shapes whose Q is not a
multiple of 8 are held to ``soft_argmax_flat`` instead (the JAX kernel's
``_block_q`` picks a block that does not divide such Q).  Kernel-vs-plain
checks on the card are at the end, marked ``cuda``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from coponerf_tpu.ops.pallas.soft_argmax import soft_argmax_both as jax_soft_argmax_both
from coponerf_tpu_torch.ops import soft_argmax as sa
from coponerf_tpu_torch.ops.correlation import soft_argmax_flat

torch.set_num_threads(2)


def cosine_volume(rng, B, Q, S, C=32):
    """Cosine correlations of unit features, where s token i resembles q
    token i (a peaked, flow-like volume)."""
    src = rng.randn(B, Q, C).astype(np.float32)
    trg = src[:, np.arange(S) % Q] + 0.7 * rng.randn(B, S, C).astype(np.float32)
    src /= np.linalg.norm(src, axis=-1, keepdims=True)
    trg /= np.linalg.norm(trg, axis=-1, keepdims=True)
    return np.einsum("bqc,bsc->bqs", src, trg).astype(np.float32)


VOLUMES = {
    "randn3_2x256x64": lambda: (np.random.RandomState(3).randn(2, 256, 64) * 3).astype(np.float32),
    "cosine_2x256x256": lambda: cosine_volume(np.random.RandomState(4), 2, 256, 256),
}


def _loss(a, b, lib):
    return lib.sum(lib.sin(a)) + lib.sum(b ** 2)


@pytest.fixture(scope="module", params=sorted(VOLUMES))
def case(request):
    c = VOLUMES[request.param]()
    cj = jnp.asarray(c)
    ref = [np.asarray(m) for m in jax_soft_argmax_both(cj)]
    ref_grad = np.asarray(jax.grad(lambda x: _loss(*jax_soft_argmax_both(x), jnp))(cj))
    ct = torch.tensor(c, requires_grad=True)
    got = sa.soft_argmax_both(ct)
    got_grad, = torch.autograd.grad(_loss(*got, torch), ct)
    return ref, ref_grad, [m.detach().numpy() for m in got], got_grad.numpy()


def test_soft_argmax_both_matches_jax(case):
    ref, _, got, _ = case
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_soft_argmax_both_gradient_matches_jax(case):
    _, ref_grad, _, got_grad = case
    np.testing.assert_allclose(got_grad, ref_grad, atol=1e-4)


def test_soft_argmax_both_gradcheck_f64():
    c = torch.tensor(np.random.RandomState(5).randn(1, 16, 9) * 0.02, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(sa.soft_argmax_both, (c,))


@pytest.mark.parametrize("shape", [(1, 36, 49), (2, 100, 16)])
def test_soft_argmax_both_matches_flat_off_the_tile(shape):
    """Q and S not multiples of 8 (or of the kernels' tiles)."""
    c = torch.tensor(np.random.RandomState(6).randn(*shape).astype(np.float32) * 3, requires_grad=True)
    a, b = sa.soft_argmax_both(c)
    fa, fb = soft_argmax_flat(c, axis=2), soft_argmax_flat(c, axis=1)
    torch.testing.assert_close(a, fa, atol=1e-5, rtol=0)
    torch.testing.assert_close(b, fb, atol=1e-5, rtol=0)
    g, = torch.autograd.grad(_loss(a, b, torch), c)
    gf, = torch.autograd.grad(_loss(fa, fb, torch), c)
    torch.testing.assert_close(g, gf, atol=1e-4, rtol=0)


def test_wrappers_check_their_inputs():
    with pytest.raises(ValueError):
        sa.soft_argmax_stats(torch.zeros(1, 10, 16))       # 10 tokens form no grid
    with pytest.raises(ValueError):
        sa.soft_argmax_stats(torch.zeros(16, 16))
    c = torch.zeros(1, 16, 9)
    row, col = sa.soft_argmax_stats(c)
    with pytest.raises(ValueError):
        sa.soft_argmax_bwd(c, row, col, torch.zeros(1, 2, 9), torch.zeros(1, 2, 9))


# ------------------------------------------- kernels vs plain, on the card --

SHAPES = [(2, 256, 256), (1, 1024, 4096), (1, 36, 49), (2, 100, 324)]
# the forward's decomposition (32-row chunks, 256-column strips, bands of
# chunks spread over the SMs): B above 6 with ragged chunks and strips, rows
# that do not split evenly into bands, 64 strips of one short band, and a
# volume narrower than one strip
STATS_SHAPES = SHAPES + [(7, 2500, 900), (3, 4900, 1024), (1, 64, 16384), (2, 324, 100)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_volume(shape, cuda):
    return torch.tensor(cosine_volume(np.random.RandomState(7), *shape), device=cuda)


def _assert_stats_match(got, ref):
    for g, r in zip(got, ref):
        torch.testing.assert_close(g[:, 0], r[:, 0], atol=0, rtol=0)
        torch.testing.assert_close(g[:, 1], r[:, 1], atol=0, rtol=1e-5)
        torch.testing.assert_close(g[:, 2:] / g[:, 1:2], r[:, 2:] / r[:, 1:2], atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", STATS_SHAPES)
def test_stats_kernel_matches_plain(cuda, shape):
    """The max is exact; the sums are taken in another order (strip and
    band partials merged with a rescale), hence 1e-5 relative on the
    partition and 1e-5 absolute on the expectations, which lie in [-1, 1]."""
    c = _card_volume(shape, cuda)
    _assert_stats_match(sa.soft_argmax_stats(c), sa.soft_argmax_stats_plain(c, 0.02))


@pytest.mark.cuda
def test_stats_kernel_on_unaligned_rows(cuda):
    """A volume 4 bytes past a 16-byte boundary: the producer warp copies
    the rows itself instead of bulk copies."""
    c = _card_volume((2, 256, 256), cuda)
    flat = torch.empty(c.numel() + 1, device=cuda)
    flat[1:] = c.reshape(-1)
    shifted = flat[1:].view(c.shape)
    assert shifted.data_ptr() % 16
    _assert_stats_match(sa.soft_argmax_stats(shifted), sa.soft_argmax_stats_plain(c, 0.02))


@pytest.mark.cuda
def test_stats_kernel_is_reproducible_and_resets_its_counters(cuda):
    """The same call twice gives the same bits (every merge in index
    order), and calls back to back at other shapes, which reuse the
    launch's arrival counters, each match the plain version: every launch
    leaves its counters at zero."""
    c = _card_volume((6, 1024, 1024), cuda)
    first = sa.soft_argmax_stats(c)
    second = sa.soft_argmax_stats(c)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    other = _card_volume((2, 2500, 900), cuda)
    got = [sa.soft_argmax_stats(x) for x in (other, c, other)]
    _assert_stats_match(got[0], sa.soft_argmax_stats_plain(other, 0.02))
    _assert_stats_match(got[1], sa.soft_argmax_stats_plain(c, 0.02))
    _assert_stats_match(got[2], sa.soft_argmax_stats_plain(other, 0.02))
    for a, b in zip(got[1], first):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_kernel_matches_plain(cuda, shape):
    """exp2 with beta folded into the scale against exp(x / beta), and
    another association of the products: 1e-4 of the largest |dc|."""
    c = _card_volume(shape, cuda)
    B, Q, S = shape
    row, col = sa.soft_argmax_stats_plain(c, 0.02)
    rowf = torch.cat([row[:, :2], row[:, 2:] / row[:, 1:2]], dim=1)
    colf = torch.cat([col[:, :2], col[:, 2:] / col[:, 1:2]], dim=1)
    g = torch.Generator(device=cuda).manual_seed(0)
    dr = torch.randn(B, 2, Q, device=cuda, generator=g)
    dcol = torch.randn(B, 2, S, device=cuda, generator=g)
    got = sa.soft_argmax_bwd(c, rowf, colf, dr, dcol)
    ref = sa.soft_argmax_bwd_plain(c, rowf, colf, dr, dcol, 0.02)
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
def test_soft_argmax_both_on_card_matches_flat(cuda):
    c = _card_volume((2, 256, 256), cuda).requires_grad_()
    before = (sa.soft_argmax_stats.launches, sa.soft_argmax_bwd.launches)
    a, b = sa.soft_argmax_both(c)
    fa, fb = soft_argmax_flat(c, axis=2), soft_argmax_flat(c, axis=1)
    torch.testing.assert_close(a, fa, atol=1e-5, rtol=0)
    torch.testing.assert_close(b, fb, atol=1e-5, rtol=0)
    g, = torch.autograd.grad(_loss(a, b, torch), c)
    gf, = torch.autograd.grad(_loss(fa, fb, torch), c)
    assert (g - gf).abs().max().item() <= 1e-4 * gf.abs().max().item()
    assert (sa.soft_argmax_stats.launches, sa.soft_argmax_bwd.launches) == (before[0] + 1, before[1] + 1)
