"""The training slice's ops held to the JAX package on the CPU: K4's plain
version and the two differentiable samplers, K1's corner-id entry, the
gradients of ``split_dense_relu``, ``convmap_sample_pair`` and
``ssim_warp_packed``, the losses, train-mode BatchNorm and the geodesic
distance.  Kernel-vs-plain checks on the card are at the end, marked ``cuda``.

Inputs are made with numpy from a seed and fed to both.  Tolerances, with
their reasons:
  - K4 against the JAX kernel (Pallas interpreted): 1e-2 of the max, since
    the JAX kernel rounds the cotangent and the one-hot weights to bf16 in
    its dot (``bilinear_sample.py:444-447``); the port keeps f32; given
    inputs rounded as that kernel rounds them, 1e-5 of the max (f32 sum
    order), which shows the rounding is the whole difference;
  - K4 against JAX's exact ``grid_sample`` VJP, and every f32 gradient
    (split_dense_relu, convmap_sample_pair, ssim_warp_packed): f32 sum-order
    round-off, 1e-5 absolute or 1e-4 relative of the max;
  - the one-hot samplers' table gradients against ``jax.grad`` of the JAX
    samplers: 2e-2 of the max (bf16 table in the forward, bf16 weights in
    the JAX kernels), as ``tests/test_pallas_kernels.py:79-97`` holds JAX's
    own one-hot gradient to its exact one;
  - losses 1e-5 relative; BatchNorm 1e-5.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from coponerf_tpu import flow as jflow
from coponerf_tpu.geometry import geodesic_rotation_distance as j_geodesic
from coponerf_tpu.ops.convmap_sample import convmap_sample_pair as j_convmap
from coponerf_tpu.ops.grid_sample import grid_sample as j_grid_sample
from coponerf_tpu.ops.pallas import bilinear_sample as jbs
from coponerf_tpu.ops.pallas.split_matmul import split_dense_relu as j_split_dense_relu
from coponerf_tpu.training import losses as jlosses
from coponerf_tpu_torch import flow as tflow
from coponerf_tpu_torch.config import LossConfig
from coponerf_tpu_torch.geometry import geodesic_rotation_distance
from coponerf_tpu_torch.models.resnet import BatchNorm
from coponerf_tpu_torch.ops import bilinear_sample as tbs
from coponerf_tpu_torch.ops.convmap_sample import convmap_sample_pair
from coponerf_tpu_torch.ops.split_matmul import split_dense_relu
from coponerf_tpu_torch.training import losses as tlosses

torch.set_num_threads(2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x, grad=False):
    return torch.tensor(np.array(x), requires_grad=grad)


def _rel_max(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _points(rng, B, P, spread=2.4):
    """[-1, 1]-ish points, some off the image, NaN/Inf/sentinel cases."""
    pts = (rng.rand(B, P, 2) * spread - spread / 2).astype(np.float32)
    pts[0, 0] = [np.nan, 0.3]
    pts[0, 1] = [np.inf, -np.inf]
    pts[-1, 2] = [1e10, 0.1]
    return pts


# ------------------------------------------------------------------ K4 --

@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_k4_plain_matches_jax_kernel(mode):
    """Both corner decompositions (clamped ids with zeroed weights; id -1),
    through the port's K4 plain version and the JAX kernel in interpret
    mode, at a HW that is not a block multiple of the JAX kernel."""
    rng = np.random.RandomState(0)
    B, H, W, C, P = 2, 12, 20, 16, 300
    pts = _points(rng, B, P)
    if mode == "border":
        pts = np.nan_to_num(pts, nan=0.0, posinf=0.0, neginf=0.0)
    g = rng.randn(B, P, C).astype(np.float32)
    j_idx, j_w = jbs.bilinear_corner_decomposition(jnp.asarray(pts), H, W, mode)
    t_idx, t_w = tbs.bilinear_corner_decomposition(_t(pts), H, W, mode)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), atol=1e-7)
    x, y = jbs._pixel_coords(jnp.asarray(pts), H, W, mode)
    jx_idx, jx_w = jbs._corners_from_pixel_xy(x, y, W, mode != "border")
    tx, ty = tbs.pixel_xy(_t(pts), H, W, mode)
    tx_idx, tx_w = tbs.corners_from_pixel_xy(tx, ty, W, mode != "border")
    np.testing.assert_array_equal(tx_idx.numpy(), np.asarray(jx_idx))
    np.testing.assert_allclose(tx_w.numpy(), np.asarray(jx_w), atol=1e-7)
    if mode == "zeros":
        assert (tx_idx.numpy() < 0).any() and (tx_idx.numpy() >= H * W).any()
    for idx, w in ((j_idx, j_w), (jx_idx, jx_w)):
        ref = jbs.onehot_transpose_matmul(jnp.asarray(g), idx, w, H * W, block_hw=128, block_p=128)
        got = tbs.onehot_transpose_matmul(_t(g), _t(idx), _t(w), H * W)
        assert got.shape == (B, H * W, C) and got.dtype == torch.float32
        assert tbs.onehot_transpose_matmul.launches == 0
        assert _rel_max(got, ref) < 1e-2


def _bf16(x):
    return torch.tensor(np.asarray(x, np.float32)).bfloat16().float()


def _jax_onehot_weights(idx, w):
    """The weights of JAX's K4 one-hot tile (``bilinear_sample.py:440-447``):
    the corners of a point that fall on one cell summed in f32, corner
    order, at the cell's first corner (the others get 0), then rounded to
    bf16 for the dot."""
    idx, w = np.asarray(idx), np.asarray(w, np.float32)
    merged = np.zeros_like(w)
    for c in range(4):
        same = idx == idx[..., c:c + 1]
        total = np.zeros(w.shape[:-1], np.float32)
        for k in range(4):
            total = total + np.where(same[..., k], w[..., k], np.float32(0))
        merged[..., c] = np.where(same[..., :c].any(axis=-1), np.float32(0), total)
    return _bf16(merged)


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_k4_plain_with_jax_rounding_matches_jax_kernel(mode):
    """The 1e-2 of ``test_k4_plain_matches_jax_kernel`` is JAX's bf16
    rounding alone: given the one-hot weights and the cotangent rounded as
    JAX's kernel rounds them, the port's f32 plain K4 matches it to f32
    sum-order round-off (1e-5 of the max), for both decompositions, while
    the unrounded inputs miss by more."""
    rng = np.random.RandomState(0)
    B, H, W, C, P = 2, 12, 20, 16, 300
    pts = _points(rng, B, P)
    if mode == "border":
        pts = np.nan_to_num(pts, nan=0.0, posinf=0.0, neginf=0.0)
    g = rng.randn(B, P, C).astype(np.float32)
    x, y = jbs._pixel_coords(jnp.asarray(pts), H, W, mode)
    decompositions = (jbs.bilinear_corner_decomposition(jnp.asarray(pts), H, W, mode),
                      jbs._corners_from_pixel_xy(x, y, W, mode != "border"))
    for idx, w in decompositions:
        ref = jbs.onehot_transpose_matmul(jnp.asarray(g), idx, w, H * W, block_hw=128, block_p=128)
        got = tbs.onehot_transpose_matmul_plain(_bf16(g), _t(idx), _jax_onehot_weights(idx, w), H * W)
        assert _rel_max(got, ref) <= 1e-5
        assert _rel_max(tbs.onehot_transpose_matmul_plain(_t(g), _t(idx), _t(w), H * W), ref) > 1e-5


@pytest.mark.parametrize("case", ["g_dtype", "g_rank", "idx_dtype", "w_dtype", "idx_shape", "w_rows"])
def test_k4_wrapper_refuses_bad_inputs(case):
    """The wrapper's checks, which run before it picks the plain version or
    the kernel: wrong dtypes (TypeError) and shapes (ValueError)."""
    B, P, C, HW = 2, 50, 16, 64
    g = torch.randn(B, P, C)
    idx = torch.randint(-1, HW, (B, P, 4), dtype=torch.int32)
    w = torch.rand(B, P, 4)
    err = ValueError
    if case == "g_dtype":
        g, err = g.double(), TypeError
    elif case == "g_rank":
        g, err = g[0], TypeError
    elif case == "idx_dtype":
        idx, err = idx.long(), TypeError
    elif case == "w_dtype":
        w, err = w.half(), TypeError
    elif case == "idx_shape":
        idx = idx[:, :, :3]
    else:
        w = w[:1]
    with pytest.raises(err):
        tbs.onehot_transpose_matmul(g, idx, w, HW)


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_k4_matches_exact_grid_sample_vjp(mode):
    """The port's table-gradient sampler against JAX's own autodiff of the
    exact gather (no Pallas on either side of the comparison)."""
    rng = np.random.RandomState(1)
    img = rng.rand(2, 10, 14, 8).astype(np.float32)
    pts = _points(rng, 2, 96).reshape(2, 12, 8, 2)
    if mode == "border":
        pts = np.nan_to_num(pts, nan=0.0, posinf=0.0, neginf=0.0)
    cot = rng.randn(2, 12, 8, 8).astype(np.float32)
    ref = jax.grad(lambda im: jnp.sum(j_grid_sample(im, jnp.asarray(pts), mode) * cot))(jnp.asarray(img))
    ti = _t(img, grad=True)
    out = tbs.grid_sample_tablegrad(ti, _t(pts), mode)
    np.testing.assert_allclose(_np(out), _np(j_grid_sample(jnp.asarray(img), jnp.asarray(pts), mode)), atol=1e-6)
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_samplers_table_gradients_match_jax(mode):
    """The port's two differentiable samplers against ``jax.grad`` of the
    JAX package's (tablegrad: K4 in interpret mode; one-hot: K1 + K4)."""
    rng = np.random.RandomState(3)
    img = rng.rand(2, 16, 16, 32).astype(np.float32)
    pts = (rng.rand(2, 32, 4, 2) * 2.2 - 1.1).astype(np.float32)
    cot = rng.rand(2, 32, 4, 32).astype(np.float32)
    jimg, jpts = jnp.asarray(img), jnp.asarray(pts)
    cases = (
        (jbs.grid_sample_tablegrad, tbs.grid_sample_tablegrad, 1e-2),
        (lambda im, p, m: jbs.grid_sample_onehot(im, p, m, out_dtype=jnp.bfloat16), tbs.grid_sample_onehot, 2e-2),
    )
    for jfn, tfn, tol in cases:
        ref = jax.grad(lambda im: jnp.sum(jfn(im, jpts, mode).astype(jnp.float32) * cot))(jimg)
        ti = _t(img, grad=True)
        (tfn(ti, _t(pts), mode).float() * _t(cot)).sum().backward()
        assert ti.grad.dtype == torch.float32
        assert _rel_max(ti.grad, ref) < tol


def test_corner_sample_entry_matches_jax():
    """K1's corner-id entry (forward) and its differentiable wrapper
    (backward K4) against ``onehot_matmul_sample`` / ``onehot_sample_diff``,
    with ids outside the table skipped."""
    rng = np.random.RandomState(4)
    B, HW, C, P = 2, 256, 16, 200
    table = rng.rand(B, HW, C).astype(np.float32)
    idx = rng.randint(0, HW, size=(B, P, 4)).astype(np.int32)
    idx[0, :5, 1] = -1
    idx[1, :5, 2] = HW + 3
    w = rng.rand(B, P, 4).astype(np.float32)
    cot = rng.randn(B, P, C).astype(np.float32)
    jt = jnp.asarray(table).astype(jnp.bfloat16)
    tt = _t(table).bfloat16()
    ref = jbs.onehot_matmul_sample(jt, jnp.asarray(idx), jnp.asarray(w), block_p=128, block_hw=128)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = tbs.corner_sample(tt, _t(idx), _t(w), out_dtype)
        assert got.dtype == out_dtype
        assert _rel_max(got, ref) < 1e-2
    assert tbs.corner_sample.launches == 0
    jg = jax.grad(lambda t: jnp.sum(jbs.onehot_sample_diff(t, jnp.asarray(idx), jnp.asarray(w), jnp.float32) * cot))(jt)
    tg = tt.clone().requires_grad_(True)
    (tbs.onehot_sample_diff(tg, _t(idx), _t(w)) * _t(cot)).sum().backward()
    assert tg.grad.dtype == torch.bfloat16
    assert _rel_max(tg.grad, jg) < 2e-2


# ----------------------------------------------- autograd of the other ops --

def test_split_dense_relu_gradients_match_jax():
    rng = np.random.RandomState(5)
    T, widths = 40, (32, 32, 32, 16)
    parts = [rng.randn(2, T, w).astype(np.float32) for w in widths]
    parts.append(np.tanh(rng.randn(2, T, 3)).astype(np.float32))
    K = sum(widths) + 3
    kernel = (rng.randn(K, 64) / np.sqrt(K)).astype(np.float32)
    bias = (rng.randn(64) * 0.1).astype(np.float32)
    fk = (rng.randn(64, 16) / 8).astype(np.float32)
    c_out = rng.randn(2, T, 64).astype(np.float32)
    c_k = rng.randn(2, T, 16).astype(np.float32)

    def jloss(parts, kernel, bias, fk):
        out, k = j_split_dense_relu(tuple(parts), kernel, bias, fk, jnp.float32)
        return jnp.sum(out * c_out) + jnp.sum(k * c_k)

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3))([jnp.asarray(p) for p in parts], kernel, bias, fk)
    tp = [_t(p, grad=True) for p in parts]
    tw = [_t(a, grad=True) for a in (kernel, bias, fk)]
    out, k = split_dense_relu(tp, *tw)
    ((out * _t(c_out)).sum() + (k * _t(c_k)).sum()).backward()
    for a, b in zip([p.grad for p in tp] + [t.grad for t in tw], list(ref[0]) + list(ref[1:])):
        assert _rel_max(a, b) < 1e-4


@pytest.mark.parametrize("low", [False, True])
def test_convmap_sample_pair_gradients_match_jax(low):
    """Values and the direct conv-kernel/bias gradients, in the exact (f32)
    and the fast (bf16 conv and table) settings."""
    rng = np.random.RandomState(6)
    BV, H, W, P = 4, 16, 16, 60
    rgb = rng.randn(BV, H, W, 3).astype(np.float32)
    kernel = (rng.randn(7, 7, 3, 8) / np.sqrt(147)).astype(np.float32)   # flax HWIO
    bias = (rng.randn(8) * 0.1).astype(np.float32)
    gp = (rng.rand(BV, P, 2) * 2 - 1).astype(np.float32)
    gs = _points(rng, BV, P)
    cp, cs = rng.randn(BV, P, 8).astype(np.float32), rng.randn(BV, P, 8).astype(np.float32)

    def jloss(k, b):
        sp, ss = j_convmap(jnp.asarray(rgb), k, b, jnp.asarray(gp), jnp.asarray(gs), low, low)
        return jnp.sum(sp.astype(jnp.float32) * cp) + jnp.sum(ss.astype(jnp.float32) * cs), (sp, ss)

    (_, (jsp, jss)), (jdk, jdb) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(kernel), jnp.asarray(bias))
    tk = _t(kernel.transpose(3, 2, 0, 1), grad=True)
    tb = _t(bias, grad=True)
    sp, ss = convmap_sample_pair(_t(rgb), tk, tb, _t(gp), _t(gs), low, low)
    ((sp.float() * _t(cp)).sum() + (ss.float() * _t(cs)).sum()).backward()
    tol = 2e-2 if low else 1e-4
    assert _rel_max(sp, jsp) < tol and _rel_max(ss, jss) < tol
    assert _rel_max(tk.grad.permute(2, 3, 1, 0), jdk) < tol
    assert _rel_max(tb.grad, jdb) < tol


def test_ssim_warp_packed_values_and_flow_gradients_match_jax():
    rng = np.random.RandomState(7)
    im0 = rng.rand(1, 3, 16, 16).astype(np.float32)
    im1 = rng.rand(1, 3, 16, 16).astype(np.float32)
    ff = (rng.randn(1, 2, 4, 4) * 0.5).astype(np.float32)
    fb = (rng.randn(1, 2, 4, 4) * 0.5).astype(np.float32)

    def jloss(a, b, f, g):
        w1, w0, mf, mb = jflow.ssim_warp_packed(a, b, f, g, out_size=16, scale=4.0)
        return jnp.sum(w1 ** 2 * mf[:, None]) + jnp.sum(w0 ** 2 * mb[:, None]), (w1, w0, mf, mb)

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(im0, im1, ff, fb)
    ts = [_t(a, grad=True) for a in (im0, im1, ff, fb)]
    w1, w0, mf, mb = tflow.ssim_warp_packed(*ts, out_size=16, scale=4.0)
    for a, b in zip((w1, w0), jout[:2]):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5)
    for a, b in zip((mf, mb), jout[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ((w1 ** 2 * mf[:, None]).sum() + (w0 ** 2 * mb[:, None]).sum()).backward()
    for t, g in zip(ts, jgrads):   # images and both flows
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5, rtol=1e-4)


# ------------------------------------------------------------------ losses --

def _loss_inputs(rng, B=2, N=24, H=16):
    """Model outputs and a batch of the shapes ``lf_loss`` reads."""
    rot = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(2 * B)]).astype(np.float32)
    rot *= np.sign(np.linalg.det(rot))[:, None, None]
    pose = np.tile(np.eye(4, dtype=np.float32), (2 * B, 1, 1))
    pose[:, :3, :3] = rot
    pose[:, :3, 3] = rng.randn(2 * B, 3) * 0.3
    pose[0, :3, :3] = np.eye(3)   # an aligned pair: the eps clip is active
    pose[B, :3, :3] = np.eye(3)
    out = {
        "rgb": rng.rand(B, 1, N, 3).astype(np.float32) * 2 - 1,
        "flow": ((rng.randn(B, 2, 4, 4) * 0.7).astype(np.float32), (rng.randn(B, 2, 4, 4) * 0.7).astype(np.float32)),
        "T_to_C1_pts": (rng.rand(B, N, 2) * H).astype(np.float32),
        "C2_pts_to_C1": (rng.rand(B, N, 2) * H).astype(np.float32),
        "mask_c2": rng.rand(B, N) > 0.3,
        "matchability_cycle_mask": (rng.rand(B, N) > 0.2).astype(np.float32),
        "rel_pose": pose[:B], "gt_rel_pose": pose[B:],
    }
    out["rgb"][0, 0, 0, 0] = np.nan
    out["C2_pts_to_C1"][0, :3] += 30.0   # beyond the 20 px validity cut
    batch = {"context": {"rgb": rng.rand(B, 2, H, H, 3).astype(np.float32) * 2 - 1},
             "query": {"rgb": rng.rand(B, 1, N, 3).astype(np.float32) * 2 - 1}}
    return out, batch


def test_losses_match_jax():
    rng = np.random.RandomState(8)
    out, batch = _loss_inputs(rng)
    from coponerf_tpu.config import LossConfig as JLossConfig

    kw = dict(pose=True, cycle=True, ssim=True)
    jl, _ = jlosses.lf_loss(JLossConfig(**kw), jax.tree.map(jnp.asarray, batch),
                            jax.tree.map(jnp.asarray, out), jax.tree.map(jnp.asarray, batch["query"]))

    def tt(x):
        return {k: tt(v) for k, v in x.items()} if isinstance(x, dict) else (
            tuple(_t(v) for v in x) if isinstance(x, tuple) else _t(x))

    tl, _ = tlosses.lf_loss(LossConfig(**kw), tt(batch), tt(out), tt(batch["query"]))
    assert set(tl) == set(jl) == {"img_loss", "ssim_loss", "cycle_loss", "pose_loss"}
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    a, b = rng.randn(32).astype(np.float32) * 3, rng.randn(32).astype(np.float32)
    np.testing.assert_allclose(tlosses.huber(_t(a), _t(b)).numpy(), np.asarray(jlosses.huber(a, b)), atol=1e-6)
    img1, img2 = rng.rand(1, 3, 32, 32).astype(np.float32), rng.rand(1, 3, 32, 32).astype(np.float32)
    mask = (rng.rand(1, 1, 32, 32) > 0.3).astype(np.float32)
    np.testing.assert_allclose(float(tlosses.masked_ssim_loss(_t(img1), _t(img2), _t(mask))),
                               float(jlosses.masked_ssim_loss(img1, img2, mask)), rtol=1e-5)


def test_geodesic_rotation_distance_matches_jax():
    rng = np.random.RandomState(9)
    m1 = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(6)]).astype(np.float32)
    m2 = m1.copy()
    m2[3:] = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(3)])
    for eps in (0.0, 1e-7):
        np.testing.assert_allclose(geodesic_rotation_distance(_t(m1), _t(m2), eps).numpy(),
                                   np.asarray(j_geodesic(m1, m2, eps)), atol=1e-6)
    t1 = _t(m1, grad=True)
    geodesic_rotation_distance(t1, _t(m2), 1e-7).sum().backward()
    jg = jax.grad(lambda a: jnp.sum(j_geodesic(a, m2, 1e-7)))(m1)
    assert torch.isfinite(t1.grad).all()
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(jg), atol=1e-3, rtol=1e-4)


# -------------------------------------------------------------- BatchNorm --

def test_train_mode_batchnorm_matches_flax():
    """Output, input gradient and the running statistics after one and two
    train-mode steps (biased variance, momentum 0.9 on the old value), then
    an eval-mode output from the updated statistics."""
    import flax.linen as fnn   # here: the card's machine has no flax

    rng = np.random.RandomState(10)
    C = 6
    xs = [(rng.randn(4, 5, 7, C) * 3 + 2).astype(np.float32) for _ in range(2)]
    scale = (rng.rand(C) + 0.5).astype(np.float32)
    bias = rng.randn(C).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.zeros(C, np.float32), "var": np.ones(C, np.float32)}}
    port = BatchNorm(C)
    with torch.no_grad():
        port.weight.copy_(_t(scale))
        port.bias.copy_(_t(bias))
    for x in xs:
        y, mut = bn.apply(variables, x, mutable=["batch_stats"])
        xt = _t(x.transpose(0, 3, 1, 2), grad=True)
        yt = port(xt, train=True)
        np.testing.assert_allclose(yt.detach().numpy().transpose(0, 2, 3, 1), np.asarray(y), atol=1e-5)
        cot = rng.randn(*x.shape).astype(np.float32)
        jg = jax.grad(lambda a: jnp.sum(bn.apply(variables, a, mutable=["batch_stats"])[0] * cot))(x)
        (yt * _t(cot.transpose(0, 3, 1, 2))).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), np.asarray(jg), atol=1e-5)
        variables = {"params": variables["params"], "batch_stats": mut["batch_stats"]}
        np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), atol=1e-6)
        np.testing.assert_allclose(port.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), atol=1e-5)
    y_eval = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5).apply(variables, xs[0])
    with torch.no_grad():
        yt = port(_t(xs[0].transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(yt.numpy().transpose(0, 2, 3, 1), np.asarray(y_eval), atol=1e-5)


# ------------------------------------------- kernels vs plain, on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["border", "zeros"])
@pytest.mark.parametrize("hw", [16, 32, 64])
def test_k4_kernel_matches_plain(cuda, mode, hw):
    """K4 at each small level's table size, both corner decompositions, bf16
    and f32 cotangents; atomics change the f32 sum order, hence 1e-4."""
    g = torch.Generator(device=cuda).manual_seed(hw)
    B, P, C = 2, 3000, 256
    pts = torch.rand(B, P, 2, device=cuda, generator=g) * 2.4 - 1.2
    cot = torch.randn(B, P, C, device=cuda, generator=g)
    x, y = tbs.pixel_xy(pts, hw, hw, mode)
    for idx, w in (tbs.bilinear_corner_decomposition(pts, hw, hw, mode),
                   tbs.corners_from_pixel_xy(x, y, hw, mode != "border")):
        for gc in (cot, cot.bfloat16()):
            got = tbs.onehot_transpose_matmul(gc, idx.contiguous(), w.contiguous(), hw * hw)
            ref = tbs.onehot_transpose_matmul_plain(gc, idx, w, hw * hw)
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def _ray_points(g, B, n_rays, S, shift, dev):
    """Ray-major (B, n_rays * S, 2) points as training lays them out:
    token n*S + s, each ray a segment across the image (shift moves part
    of every segment off it)."""
    start = torch.rand(B, n_rays, 1, 2, device=dev, generator=g) * 0.4 - 1.0 - shift
    end = torch.rand(B, n_rays, 1, 2, device=dev, generator=g) * 0.4 + 0.6
    t = torch.linspace(0, 1, S, device=dev)[None, None, :, None]
    return (start + (end - start) * t).reshape(B, n_rays * S, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["border", "zeros"])
@pytest.mark.parametrize("hw", [16, 32, 64])
def test_k4_kernel_matches_plain_training_layout(cuda, mode, hw):
    """K4 on ray-major training points (2 rows x 192 rays x 64 samples,
    C 256; the kernel sorts them by cell and merges runs of 64), and on the
    same points less 37 (a P that is no multiple of the run), bf16 and f32
    cotangents; atomics change the f32 sum order, hence 1e-4."""
    g = torch.Generator(device=cuda).manual_seed(100 + hw)
    B, C = 2, 256
    pts = _ray_points(g, B, 192, 64, 0.0 if mode == "border" else 0.3, cuda)
    for P in (pts.shape[1], pts.shape[1] - 37):
        x, y = tbs.pixel_xy(pts[:, :P].contiguous(), hw, hw, mode)
        idx, w = tbs.corners_from_pixel_xy(x, y, hw, mode != "border")
        cot = torch.randn(B, P, C, device=cuda, generator=g)
        for gc in (cot.bfloat16(), cot):
            n = tbs.onehot_transpose_matmul.launches
            got = tbs.onehot_transpose_matmul(gc, idx.contiguous(), w.contiguous(), hw * hw)
            assert tbs.onehot_transpose_matmul.launches == n + 1
            ref = tbs.onehot_transpose_matmul_plain(gc, idx, w, hw * hw)
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_k4_kernel_matches_plain_large_table(cuda, mode):
    """The 256^2 x 64 conv_map level (training sends it through K4 when
    convmap_direct_grad is off): 65536 cells, which the sort bins 16 at a
    time."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, C, hw = 2, 64, 256
    pts = _ray_points(g, B, 192, 64, 0.0 if mode == "border" else 0.3, cuda)
    x, y = tbs.pixel_xy(pts, hw, hw, mode)
    idx, w = tbs.corners_from_pixel_xy(x, y, hw, mode != "border")
    cot = torch.randn(B, pts.shape[1], C, device=cuda, generator=g).bfloat16()
    got = tbs.onehot_transpose_matmul(cot, idx.contiguous(), w.contiguous(), hw * hw)
    torch.testing.assert_close(got, tbs.onehot_transpose_matmul_plain(cot, idx, w, hw * hw), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_k4_kernel_refuses_channels_off_the_vector_width(cuda):
    """On the card K4 takes rows of a multiple of 8 channels (16-byte
    copies), as K1 does; other widths raise and launch nothing."""
    idx = torch.zeros(1, 10, 4, dtype=torch.int32, device=cuda)
    w = torch.ones(1, 10, 4, device=cuda)
    n = tbs.onehot_transpose_matmul.launches
    with pytest.raises(ValueError):
        tbs.onehot_transpose_matmul(torch.randn(1, 10, 12, device=cuda), idx, w, 16)
    assert tbs.onehot_transpose_matmul.launches == n


@pytest.mark.cuda
def test_corner_sample_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    table = torch.randn(2, 1024, 256, device=cuda, generator=g).bfloat16()
    idx = torch.randint(-2, 1030, (2, 3000, 4), device=cuda, generator=g, dtype=torch.int32)
    w = torch.rand(2, 3000, 4, device=cuda, generator=g)
    for out_dtype in (torch.float32, torch.bfloat16):
        torch.testing.assert_close(tbs.corner_sample(table, idx, w, out_dtype),
                                   tbs.corner_sample_plain(table, idx, w, out_dtype), atol=0, rtol=0)
