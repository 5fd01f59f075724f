"""K6: the port's ``render_core`` held to the JAX package's Pallas kernel
(``ops/pallas/experimental/render_core.py``, run in interpret mode on the
CPU) on the same seeded inputs, at real widths (levels 256/256/256/64, W1
835 -> 832, keys 128, values 416) and V=2, S=4, N=24.  On the CPU the port's
wrapper runs its plain version.

Both sides take bf16 operands with f32 sums in other orders.  An
activation whose f32 value lies next to a bf16 rounding boundary then
rounds to the neighbouring bf16 value on one side (2^-8 relative; the 832
pre-activations, the 128-wide hidden layers and the weighted sums are all
rounded).  Measured against JAX at seeds 0 and 1: ``z_sum`` 4.4e-4 of its
largest magnitude elementwise and 1.1e-5 in the mean, ``at_wt`` (in
[0, 1]) 4.7e-5 and 8.6e-7.  So ``z_sum`` is held at 3e-3 of its largest
magnitude elementwise and 1e-4 in the mean, and ``at_wt`` at 1e-3 and
1e-5.  The kernel-vs-plain checks on the
card are at the end, marked ``cuda``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from coponerf_tpu.ops.pallas.experimental.render_core import render_core as jax_render_core
from coponerf_tpu_torch import trace
from coponerf_tpu_torch.ops import render_core as rc

SPLITS = (256, 256, 256, 64)
WEIGHTS = (("w1", (835, 832)), ("w1b", (832,)), ("fka", (832, 128)), ("fkb", (832, 128)), ("fk_bias", (128,)),
           ("wk2", (128, 128)), ("bk2", (128,)), ("wq", (16, 128)), ("bq", (128,)), ("wq2", (128, 128)),
           ("bq2", (128,)), ("wra", (128, 128)), ("wrb", (16, 128)), ("brr", (128,)), ("wr2", (128, 128)),
           ("br2", (128,)), ("wenc", (416, 128)), ("benc", (128,)), ("flva", (832, 416)), ("flvb", (832, 416)),
           ("flv_bias", (416,)))


def make_inputs(rng, B, V, S, N):
    """Seeded f32 inputs: bf16-valued samples, positions and coordinates as
    the render gives them, weights scaled like the model's."""
    R, T = B * V, S * N

    def bf16(*shape, scale=1.0):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))

    tok = dict(samples_p=[np.maximum(bf16(R, T, c), 0) for c in SPLITS], pt_p=bf16(R, T, 3, scale=3.0),
               samples_s=[np.maximum(bf16(R, T, c), 0) for c in SPLITS], pt_s=bf16(R, T, 3, scale=3.0),
               lc=bf16(R, T, 16))
    w = {}
    for name, shape in WEIGHTS:
        scale = 0.1 if len(shape) == 1 else shape[0] ** -0.5
        w[name] = (rng.standard_normal(shape) * scale).astype(np.float32)
    return tok, w


def run_port(tok, w, S, V, N, device="cpu"):
    def t(x):
        return torch.from_numpy(x).to(device)

    return rc.render_core([t(x).bfloat16() for x in tok["samples_p"]], t(tok["pt_p"]),
                          [t(x).bfloat16() for x in tok["samples_s"]], t(tok["pt_s"]), t(tok["lc"]),
                          *(t(w[k]) for k, _ in WEIGHTS), S, V, N)


def check(got, ref):
    z, at = (g.float().cpu() for g in got)
    rz, rat = (torch.as_tensor(np.asarray(r, dtype=np.float32)) for r in ref)
    assert z.shape == rz.shape and at.shape == rat.shape
    assert torch.isfinite(z).all() and torch.isfinite(at).all()
    top = rz.abs().max().item()
    dz = (z - rz).abs()
    assert dz.max().item() <= 3e-3 * top, (dz.max().item(), top)
    assert dz.mean().item() <= 1e-4 * top, (dz.mean().item(), top)
    da = (at - rat).abs()
    assert da.max().item() <= 1e-3 and da.mean().item() <= 1e-5, (da.max().item(), da.mean().item())


@pytest.mark.parametrize("seed", [0, 1])
def test_render_core_matches_jax(seed):
    B, V, S, N = 1, 2, 4, 24
    tok, w = make_inputs(np.random.default_rng(seed), B, V, S, N)

    def j(x):
        return jnp.asarray(x)

    ref = jax_render_core([j(x).astype(jnp.bfloat16) for x in tok["samples_p"]], j(tok["pt_p"]),
                          [j(x).astype(jnp.bfloat16) for x in tok["samples_s"]], j(tok["pt_s"]), j(tok["lc"]),
                          *(j(w[k]) for k, _ in WEIGHTS), S=S, V=V, n_rays=N)
    got = run_port(tok, w, S, V, N)
    check(got, ref)
    at = got[1].numpy()
    np.testing.assert_allclose(at.sum(-1), 1.0, atol=1e-5)


K6_COUNTERS = ("k6_value_rows", "k6_value_slots")


def test_render_core_cpu_counts_no_launch():
    tok, w = make_inputs(np.random.default_rng(2), 2, 2, 3, 5)
    before = rc.render_core.launches
    counted = [trace.counters[k] for k in K6_COUNTERS]
    z, at = run_port(tok, w, 3, 2, 5)
    assert z.shape == (2, 5, 416) and at.shape == (2, 5, 6)
    assert rc.render_core.launches == before
    assert [trace.counters[k] for k in K6_COUNTERS] == counted


def _slots_by_walk(B, N, grid, G):
    """The row slots of the kernel's walk: block i takes rays [lo, hi) and
    runs a value product for each group of up to G of them."""
    rays = B * N
    slots = 0
    for i in range(grid):
        lo, hi = i * rays // grid, (i + 1) * rays // grid
        slots += G * len(range(lo, hi, G))
    return slots


@pytest.mark.parametrize("B, N, grid, vs, rows, slots", [
    (1, 32768, 132, 128, 32768, 33792),   # eval-s64-pair's launch: 248-249 rays a block, 4 groups of 64
    (1, 9000, 132, 8, 9000, 16896),       # ragged: 68-69 rays a block, groups of 64 and 4-5
    (2, 200, 132, 128, 400, 8448),        # 3-4 rays a block, the groups across the b boundary
    (1, 100, 100, 128, 100, 6400),        # fewer rays than SMs: a block a ray
    (1, 4096, 132, 160, 4096, 4224),      # V*S 160: G 32, 31-32 rays a block
    (1, 4300, 132, 160, 4300, 6656),      # V*S 160, ragged: 32-33 rays a block, groups of 32 and 1
])
def test_value_counts(B, N, grid, vs, rows, slots):
    """The counters a K6 launch adds: its rays and the row slots of its
    groups' value products (G a group), as the kernel walks them."""
    G = rc.group_rays(vs)
    assert G == {8: 64, 128: 64, 160: 32}[vs]
    assert rc.value_counts(B, N, grid, G) == (rows, slots) == (rows, _slots_by_walk(B, N, grid, G))
    if (B, N) == (1, 32768):
        assert 100.0 * rows / slots > 96.9


def test_group_rays_keeps_a_blocks_slots():
    """G shrinks as V*S grows, so that a block's slots (G x V*S rounded up
    to 128 tokens) stay one 64-ray group's at V*S 128; always 1..64."""
    for vs in range(1, 1025):   # the kernel takes up to 1024 tokens a ray
        G = rc.group_rays(vs)
        tiles = -(-vs // 128)
        assert 1 <= G <= rc.GROUP_ROWS and G * tiles <= rc.GROUP_ROWS < (G + 1) * tiles


def test_render_core_bench_inputs_match_jax():
    """``bench_kernels.render_core_inputs``, which the chip smoke's K6 phase
    and the kernel bench call, builds the arguments in the wrapper's
    order and shapes (``WEIGHT_SHAPES``, the JAX kernel's weights): at a
    small size they go through the port as through JAX's kernel.  A
    weight of another shape is refused."""
    from coponerf_tpu_torch.bench_kernels import render_core_inputs

    assert rc.WEIGHT_SHAPES == WEIGHTS
    S, V, N = 4, 2, 8
    args = render_core_inputs(torch.device("cpu"), S, V, N)
    assert args[-3:] == (S, V, N)
    got = rc.render_core(*args)

    def j(x):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)

    ref = jax_render_core([j(x) for x in args[0]], j(args[1]), [j(x) for x in args[2]], j(args[3]), j(args[4]),
                          *(j(x) for x in args[5:-3]), S=S, V=V, n_rays=N)
    check(got, ref)
    np.testing.assert_allclose(got[1].numpy().sum(-1), 1.0, atol=1e-5)
    bad = list(args)
    bad[5] = bad[5][:-1]
    with pytest.raises(ValueError):
        rc.render_core(*bad)


# ------------------------------------------- kernel vs plain, on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B, S, N", [(1, 64, 256), (2, 4, 24), (1, 3, 5), (1, 20, 70), (1, 80, 33), (2, 16, 13),
                                     (1, 4, 9000), (2, 64, 200), (1, 64, 100), (1, 80, 4300)])
def test_render_core_kernel_matches_plain(cuda, B, S, N):
    """V*S of 128 (the main path's: one 128-token tile a sample set), 8, 6
    and 40 tokens a ray (one ragged tile, the rows past V*S masked), 160
    (two tiles a set, the second ragged), and 32 at B 2 with N 13 (the
    rays of the second batch row, and a ray stride that is no multiple of
    8).  The value products' groups (on 132 SMs): 68-69 rays a block at
    V*S 8, in groups of 64 and a ragged last one; at B 2, N 200 a block's
    group across the two batch rows; 100 rays, fewer than the SMs, a block
    each; V*S 160, where G is 32, 32-33 rays a block, a last group of one.
    Each launch adds its rays and row slots to the trace counters."""
    tok, w = make_inputs(np.random.default_rng(S * N), B, 2, S, N)
    n = rc.render_core.launches
    counted = [trace.counters[k] for k in K6_COUNTERS]
    got = run_port(tok, w, S, 2, N, cuda)
    torch.cuda.synchronize()
    assert rc.render_core.launches == n + 1
    grid = min(torch.cuda.get_device_properties(cuda).multi_processor_count, B * N)
    rows, slots = rc.value_counts(B, N, grid, rc.group_rays(2 * S))
    assert [trace.counters[k] - c for k, c in zip(K6_COUNTERS, counted)] == [rows, slots]

    def t(x):
        return torch.from_numpy(x).to(cuda)

    ref = rc.render_core_plain([t(x).bfloat16() for x in tok["samples_p"]], t(tok["pt_p"]),
                               [t(x).bfloat16() for x in tok["samples_s"]], t(tok["pt_s"]), t(tok["lc"]),
                               *(t(w[k]) for k, _ in WEIGHTS), S=S, V=2, n_rays=N)
    check(got, [r.cpu().numpy() for r in ref])


@pytest.mark.cuda
def test_render_core_kernel_rejects_too_many_tokens(cuda):
    """The kernel keeps a ray's logits in shared memory: past
    ``max_tokens()`` tokens a ray (V*S) the wrapper raises before
    launching."""
    S = rc.max_tokens() // 2 + 1
    tok, w = make_inputs(np.random.default_rng(3), 1, 2, S, 1)
    n = rc.render_core.launches
    with pytest.raises(ValueError, match="tokens a ray"):
        run_port(tok, w, S, 2, 1, cuda)
    assert rc.render_core.launches == n
