"""K8: the multi-level sampler (``multilevel_sample``, K8a) and the
large-table sampler (``grid_sample_window``, K8b) of the port, held to the
JAX package's ``multilevel_banded_sample`` and ``grid_sample_onehot_window``
(Pallas interpreted on the CPU) at the JAX tests' own bounds
(``tests/test_pallas_kernels.py:120-161``: 2e-2 max-abs, 5e-3 mean-relative;
the JAX kernels round their one-hot weights to bf16, the port keeps them
f32).  On CPU tensors the wrappers run their plain versions, the exact
gather per level, so a 4-level call equals per-level K1 exactly.  The
kernel-vs-plain and kernel-vs-K1 checks on the card, bit for bit, are at
the end, marked ``cuda``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from coponerf_tpu.ops.pallas.experimental.multilevel_sample import multilevel_banded_sample
from coponerf_tpu.ops.pallas.experimental.windowed_sample import grid_sample_onehot_window
from coponerf_tpu_torch.ops.bilinear_sample import (
    bilinear_sample, bilinear_sample_plain, grid_sample_window, grid_sample_window_plain, multilevel_sample,
    multilevel_sample_plain,
)

torch.set_num_threads(2)

RENDER_LEVELS = ((16, 256), (32, 256), (64, 256), (256, 64))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_jax_bound(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-2)
    assert np.abs(got - ref).mean() / (np.abs(ref).mean() + 1e-6) < 5e-3


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_multilevel_sample_matches_jax(mode):
    """Three small levels at shared points with a wide-band block, and NaN /
    1e8 points under zeros padding (the shapes of the JAX kernel's test)."""
    rng = np.random.RandomState(4)
    tables = [rng.rand(2, s, s, 32).astype(np.float32) for s in (16, 32, 64)]
    base = rng.rand(2, 4096, 2).astype(np.float32) * 0.3 - 0.85
    base[:, 1024:2048] = rng.rand(2, 1024, 2) * 2.4 - 1.2
    if mode == "zeros":
        base[0, 0] = [np.nan, 1e8]
    refs = multilevel_banded_sample([jnp.asarray(t) for t in tables], jnp.asarray(base), mode,
                                    block_p=1024, sub=256)
    gots = multilevel_sample([torch.from_numpy(t).bfloat16() for t in tables], torch.from_numpy(base), mode)
    assert multilevel_sample.launches == 0
    assert len(gots) == 3
    for got, ref in zip(gots, refs):
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        _assert_jax_bound(got, ref)


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_grid_sample_window_matches_jax(mode):
    """A 64^2 x 24 table at (B, 256, 16) points with a wide-band block and
    out-of-image points, f32 output (the shapes of the JAX kernel's test)."""
    rng = np.random.RandomState(2)
    img = rng.rand(2, 64, 64, 24).astype(np.float32)
    base = rng.rand(2, 4096, 2).astype(np.float32) * 0.25 - 0.8
    base[:, 2048:3072] = rng.rand(2, 1024, 2) * 2.4 - 1.2
    if mode == "zeros":
        base[0, 0] = [np.nan, 1e8]
        base[1, 5] = [-1e8, 0.0]
    pts = base.reshape(2, 256, 16, 2)
    ref = grid_sample_onehot_window(jnp.asarray(img), jnp.asarray(pts), padding_mode=mode, block_p=1024,
                                    win_rows=8)
    got = grid_sample_window(torch.from_numpy(img).bfloat16(), torch.from_numpy(pts), mode)
    assert grid_sample_window.launches == 0
    assert got.dtype == torch.float32 and got.shape == (2, 256, 16, 24)
    _assert_jax_bound(got, ref)


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_four_render_levels_match_per_level_k1(mode):
    """The render's four levels (the 256^2 x 64 one included) in one call:
    each output equals K1's on its level exactly, keeps the grid's batch
    shape, and in f32 equals ``grid_sample_window`` of the level."""
    g = torch.Generator().manual_seed(3)
    tables = [torch.randn(2, hw, hw, C, generator=g).bfloat16() for hw, C in RENDER_LEVELS]
    pts = torch.rand(2, 40, 25, 2, generator=g) * 2.4 - 1.2
    pts[0, 0, 0] = float("nan")
    outs = multilevel_sample(tables, pts, mode)
    outs32 = multilevel_sample(tables, pts, mode, out_dtype=torch.float32)
    for t, o, o32 in zip(tables, outs, outs32):
        assert o.shape == (2, 40, 25, t.shape[-1]) and o.dtype == torch.bfloat16
        assert torch.equal(o, bilinear_sample(t, pts, mode))
        assert torch.equal(o32, grid_sample_window(t, pts, mode))
        assert torch.equal(o, o32.bfloat16())
    assert multilevel_sample.launches == grid_sample_window.launches == bilinear_sample.launches == 0


def test_multilevel_sample_rejects_bad_arguments():
    t = torch.zeros(2, 16, 16, 32, dtype=torch.bfloat16)
    pts = torch.zeros(2, 10, 2)
    for tables in ([], [t] * 5):
        with pytest.raises(ValueError):
            multilevel_sample(tables, pts, "border")
    with pytest.raises(TypeError):          # bf16 tables only, on any device
        multilevel_sample([t.float()], pts, "border")
    with pytest.raises(TypeError):
        multilevel_sample([t], pts, "border", out_dtype=torch.float16)
    with pytest.raises(ValueError):
        multilevel_sample([t], pts, "reflection")
    with pytest.raises(ValueError):         # batch of the grid and the table
        grid_sample_window(t, pts[:1])


# ------------------------------------------ kernels vs plain, on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _render_inputs(cuda, seed, mode):
    """The render's four levels; under zeros padding one NaN / 1e8 point
    (the render scrubs its border-mode points before sampling)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    tables = [torch.randn(2, hw, hw, C, device=cuda, generator=g).bfloat16() for hw, C in RENDER_LEVELS]
    pts = torch.rand(2, 3001, 2, device=cuda, generator=g) * 2.4 - 1.2
    if mode == "zeros":
        pts[0, 0] = torch.tensor([float("nan"), 1e8], device=cuda)
    return tables, pts


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_multilevel_kernel_matches_plain(cuda, mode, out_dtype):
    tables, pts = _render_inputs(cuda, 0, mode)
    before = multilevel_sample.launches
    got = multilevel_sample(tables, pts, mode, out_dtype=out_dtype)
    assert multilevel_sample.launches == before + 1
    for o, r in zip(got, multilevel_sample_plain(tables, pts, mode, out_dtype=out_dtype)):
        assert o.dtype == out_dtype and o.is_contiguous()
        torch.testing.assert_close(o, r, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_multilevel_kernel_matches_k1(cuda, mode):
    """bf16 output per level bit for bit K1's (the one-level launch of
    ``bilinear_sample``) and the plain version's, at any level count."""
    tables, pts = _render_inputs(cuda, 1, mode)
    for n in (1, 2, 4):
        for o, t in zip(multilevel_sample(tables[:n], pts, mode), tables[:n]):
            torch.testing.assert_close(o, bilinear_sample(t, pts, mode), atol=0, rtol=0)
            torch.testing.assert_close(o, bilinear_sample_plain(t, pts, mode), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_grid_sample_window_kernel_matches_plain(cuda, mode):
    g = torch.Generator(device=cuda).manual_seed(2)
    img = torch.randn(2, 256, 256, 64, device=cuda, generator=g).bfloat16()
    pts = torch.rand(2, 300, 7, 2, device=cuda, generator=g) * 2.4 - 1.2
    before = grid_sample_window.launches
    got = grid_sample_window(img, pts, mode)
    assert grid_sample_window.launches == before + 1 and got.shape == (2, 300, 7, 64)
    torch.testing.assert_close(got, grid_sample_window_plain(img, pts, mode), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_multilevel_kernel_odd_widths(cuda, mode):
    """Levels whose C / 8 is no power of two (the kernel's division path)
    beside one where it is, in one launch, over 3 batch rows and a point
    count that fills no block."""
    g = torch.Generator(device=cuda).manual_seed(3)
    tables = [torch.randn(3, h, w, c, device=cuda, generator=g).bfloat16()
              for h, w, c in ((9, 13, 24), (16, 16, 256), (5, 7, 40))]
    pts = torch.rand(3, 257, 2, device=cuda, generator=g) * 2.4 - 1.2
    for out_dtype in (torch.bfloat16, torch.float32):
        got = multilevel_sample(tables, pts, mode, out_dtype=out_dtype)
        for o, r in zip(got, multilevel_sample_plain(tables, pts, mode, out_dtype=out_dtype)):
            torch.testing.assert_close(o, r, atol=0, rtol=0)


def _sample_major_points(g, n_rays, S, shift, dev):
    """(2, S * n_rays, 2) points as the render lays them: token s*N + n on
    ray n's segment, rays in raster order of a 64-wide image, so neighbouring
    tokens sample neighbouring pixels at one depth (up to 16 of them in one
    cell of the 16^2 level); ``shift`` moves part of each segment off the
    image."""
    n = torch.arange(n_rays, device=dev, dtype=torch.float32)
    u, v = (n % 64) / 63 * 2 - 1, (n // 64) / 63 * 2 - 1
    start = torch.stack([(u + 1) / 2 - 0.95 - shift, v * 0.9], -1)
    direction = torch.randn(2, 1, 2, device=dev, generator=g) * 0.2 + torch.tensor([0.9, 0.1], device=dev)
    t = torch.linspace(0, 1, S, device=dev)
    return (start[None, None] + t[None, :, None, None] * direction[:, :, None, :]).reshape(2, -1, 2).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_multilevel_kernel_sample_major_render_points(cuda, mode):
    """K8a on the render's four levels at sample-major points (4096 rays x
    16 samples), and K8b (f32 out) on the 256^2 level at the same points,
    each bit for bit its plain version."""
    g = torch.Generator(device=cuda).manual_seed(7)
    tables = [torch.randn(2, hw, hw, C, device=cuda, generator=g).bfloat16() for hw, C in RENDER_LEVELS]
    pts = _sample_major_points(g, 4096, 16, 0.0 if mode == "border" else 0.4, cuda)
    for o, r in zip(multilevel_sample(tables, pts, mode), multilevel_sample_plain(tables, pts, mode)):
        torch.testing.assert_close(o, r, atol=0, rtol=0)
    got = grid_sample_window(tables[-1], pts, mode)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, grid_sample_window_plain(tables[-1], pts, mode), atol=0, rtol=0)
