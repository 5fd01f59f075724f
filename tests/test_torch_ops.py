"""The port's geometry, leaf ops, flow utilities and the plain versions of
its three kernels, held to the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both.  Tolerances:
geometry and leaf ops 1e-5 (f32 round-off); K1's plain version 1e-5 against
the exact JAX gather and bf16 level (2e-2 max, 5e-3 mean-relative) against
the JAX one-hot kernel, whose selection weights are bf16; K2 rtol 1e-5 in
f32 and 1e-2 relative in bf16; K3 1e-2 (bf16 activations).  The
kernel-vs-plain checks on the card are at the end, marked ``cuda``.
"""

import importlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from coponerf_tpu import flow as jflow
from coponerf_tpu.geometry import cameras as jcam
from coponerf_tpu.geometry import epipolar as jepi
from coponerf_tpu.geometry import plucker as jpl
from coponerf_tpu.ops.pallas.bilinear_sample import grid_sample_onehot
from coponerf_tpu.ops.pallas.split_matmul import split_dense_relu as j_split_dense_relu
from coponerf_tpu.ops.pallas.weighted_sum import weighted_sum_smaj as j_weighted_sum
from coponerf_tpu_torch import flow as tflow
from coponerf_tpu_torch.geometry import cameras as tcam
from coponerf_tpu_torch.geometry import epipolar as tepi
from coponerf_tpu_torch.geometry import plucker as tpl
from coponerf_tpu_torch.ops import correlation as tcorr
from coponerf_tpu_torch.ops import grid_sample as tgs
from coponerf_tpu_torch.ops import resize as trs
from coponerf_tpu_torch.ops.bilinear_sample import bilinear_sample, bilinear_sample_plain
from coponerf_tpu_torch.ops.split_matmul import split_dense_relu, split_dense_relu_plain
from coponerf_tpu_torch.ops.weighted_sum import weighted_sum_plain, weighted_sum_smaj

# coponerf_tpu.ops re-exports functions under these module names
jcorr = importlib.import_module("coponerf_tpu.ops.correlation")
jgs = importlib.import_module("coponerf_tpu.ops.grid_sample")
jrs = importlib.import_module("coponerf_tpu.ops.resize")

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **(kw or TOL))


def _poses(rng, n):
    """n random rigid transforms (f32)."""
    out = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        out[i, :3, :3] = q * np.sign(np.linalg.det(q))
        out[i, :3, 3] = rng.randn(3) * 0.3
        out[i, 3, 3] = 1.0
    return out


def _intrinsics(n, size=32.0):
    K = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    K[:, 0, 0] = K[:, 1, 1] = 0.9 * size
    K[:, 0, 2] = K[:, 1, 2] = size / 2
    return K


# ------------------------------------------------------------- geometry --

def test_camera_primitives_match_jax():
    rng = np.random.RandomState(0)
    T = _poses(rng, 4)
    _close(tcam.pose_inverse_4x4(_t(T)), jcam.pose_inverse_4x4(T))
    d6 = rng.randn(5, 6).astype(np.float32)
    _close(tcam.r6d2mat(_t(d6)), jcam.r6d2mat(d6))
    K = _intrinsics(4)
    pts = rng.randn(4, 7, 5, 3).astype(np.float32)
    pts[0, 0, 0, 2] = 0.0  # a point in the camera plane: scrubbed to the sentinel
    got = tcam.project(_t(pts[..., 0]), _t(pts[..., 1]), _t(pts[..., 2]), _t(K[:, None]))
    ref = jcam.project(pts[..., 0], pts[..., 1], pts[..., 2], K[:, None])
    _close(got, ref, atol=1e-5, rtol=1e-5)
    _close(tcam.encode_relative_point(_t(pts), _t(T.reshape(2, 2, 4, 4))),
           jcam.encode_relative_point(pts, T.reshape(2, 2, 4, 4)))
    uv = rng.rand(4, 6, 5, 2).astype(np.float32) * 2 - 1
    _close(tcam.get_ray_directions_cam(_t(uv), _t(K), 32, 32),
           jcam.get_ray_directions_cam(uv, K, 32, 32))
    w = rng.randn(4, 9, 3).astype(np.float32)
    _close(tcam.project_cam2world(_t(w), _t(T)), jcam.project_cam2world(w, T), atol=1e-5, rtol=1e-4)
    kp = rng.rand(4, 9, 2).astype(np.float32) * 32
    depth = rng.rand(4, 9).astype(np.float32) + 1.0
    Kr = K[:, :3, :3]
    _close(tcam.batch_project_to_other_img(_t(kp), _t(depth), _t(Kr), _t(Kr), _t(T)),
           jcam.batch_project_to_other_img(kp, depth, Kr, Kr, T), atol=1e-4, rtol=1e-5)


def test_plucker_and_epipolar_point_match_jax():
    rng = np.random.RandomState(1)
    T = _poses(rng, 2)
    K = _intrinsics(2)
    uv = rng.rand(2, 6, 2).astype(np.float32) * 32
    _close(tpl.plucker_embedding(_t(T), _t(uv), _t(K)), jpl.plucker_embedding(T, uv, K))
    q = np.asarray(jpl.plucker_embedding(T, uv, K))
    pv = rng.rand(2, 6, 5, 2).astype(np.float32) * 2 - 1
    c2w = _poses(rng, 2)
    got = tpl.get_3d_point_epipolar(_t(q), _t(pv), _t(c2w), 32, 32, _t(K))
    ref = jpl.get_3d_point_epipolar(q, pv, c2w, 32, 32, K)
    _close(got[0], ref[0], atol=1e-4, rtol=1e-5)
    _close(got[1], ref[1], atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


def test_project_rays_match_jax():
    rng = np.random.RandomState(2)
    c2w = _poses(rng, 2)
    K = _intrinsics(2, 1.0)  # normalized to a 0-1 image
    dirs = rng.randn(2, 40, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.broadcast_to(c2w[:, None, :3, 3] * 0.5, (2, 40, 3)).copy()
    origins[1, :5] = 0.0  # origins at the camera centre
    eye = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    got = tepi.project_rays(_t(origins), _t(dirs), _t(eye), _t(K))
    ref = jepi.project_rays(origins, dirs, eye, K)
    np.testing.assert_array_equal(got["overlaps_image"].numpy(), np.asarray(ref["overlaps_image"]))
    for k in ("xy_min", "xy_max"):
        a = np.nan_to_num(np.asarray(ref[k]), nan=0.0, posinf=0.0, neginf=0.0)
        b = np.nan_to_num(got[k].numpy(), nan=0.0, posinf=0.0, neginf=0.0)
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5)


# -------------------------------------------------------------- leaf ops --

@pytest.mark.parametrize("align", [False, True])
def test_resize_matches_jax(align):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 7, 4).astype(np.float32)
    _close(trs.resize_bilinear(_t(x), (9, 4), align), jrs.resize_bilinear(x, (9, 4), align))
    y = rng.randn(2, 2, 8, 8).astype(np.float32)
    _close(trs.resize_nchw(_t(y), (32, 32), align), jrs.resize_nchw(y, (32, 32), align))


def test_correlation_and_soft_argmax_match_jax():
    rng = np.random.RandomState(4)
    src = rng.randn(2, 16, 8).astype(np.float32)
    trg = rng.randn(2, 16, 8).astype(np.float32)
    _close(tcorr.correlation_tokens(_t(src), _t(trg), (4, 4)), jcorr.correlation_tokens(src, trg, (4, 4)))
    logits = rng.randn(2, 64, 64).astype(np.float32) * 0.05
    for axis in (1, 2):
        got = tcorr.soft_argmax_flat(_t(logits), axis)
        ref = jcorr.soft_argmax_flat(logits, axis)
        _close(got, ref)
        _close(tcorr.unnormalise_and_convert_mapping_to_flow(got),
               jcorr.unnormalise_and_convert_mapping_to_flow(ref))


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_grid_sample_matches_jax(mode):
    rng = np.random.RandomState(5)
    img = rng.rand(2, 16, 12, 8).astype(np.float32)
    pts = rng.rand(2, 64, 8, 2).astype(np.float32) * 2.4 - 1.2
    if mode == "zeros":  # NaN, Inf and the 1e10 projection sentinel
        pts[0, 0, 0] = [np.nan, 1e8]
        pts[0, 0, 1] = [np.inf, -np.inf]
        pts[1, 3, 2] = [1e10, 0.3]
    _close(tgs.grid_sample(_t(img), _t(pts), mode), jgs.grid_sample(img, pts, mode))


def test_flow_utilities_match_jax():
    rng = np.random.RandomState(6)
    f_fwd = (rng.randn(1, 2, 8, 8) * 2).astype(np.float32)
    f_bwd = (rng.randn(1, 2, 8, 8) * 2).astype(np.float32)
    _close(tflow.warp(_t(f_bwd), _t(f_fwd)), jflow.warp(f_bwd, f_fwd))
    got = tflow.cyclic_consistency_masks(_t(f_fwd), _t(f_bwd), out_size=32, scale=1.0)
    ref = jflow.cyclic_consistency_masks(f_fwd, f_bwd, out_size=32, scale=1.0)
    for a, b in zip(got, ref):
        _close(a, b)
    up = got[1]
    kps = rng.rand(1, 20, 2).astype(np.float32) * 40 - 4
    kps[0, 0] = [np.nan, 3.0]
    src, mask = tflow.flow2kps_from_upsampled(_t(kps), up, 20)
    jsrc, jmask = jflow.flow2kps_from_upsampled(jnp.asarray(kps), ref[1], 20)
    _close(src, jsrc)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    conf = rng.rand(1, 32, 32).astype(np.float32)
    _close(tflow.mask_from_confidence(_t(kps), _t(conf), 20, (32, 32)),
           jflow.mask_from_confidence(jnp.asarray(kps), conf, 20, (32, 32)))


# ------------------------------------------- kernels: the plain versions --

@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_bilinear_sample_plain_matches_jax(mode):
    """K1's plain version (what the wrapper runs on CPU tensors): exact
    against the JAX gather, bf16 level against the banded one-hot kernel."""
    rng = np.random.RandomState(7)
    img = rng.rand(2, 32, 32, 32).astype(np.float32)
    pts = rng.rand(2, 512, 2).astype(np.float32) * 0.3 - 0.8
    pts[:, 256:] = rng.rand(2, 256, 2) * 2.4 - 1.2
    if mode == "zeros":
        pts[0, 0] = [np.nan, 1e8]
    _close(bilinear_sample_plain(_t(img), _t(pts), mode), jgs.grid_sample(img, pts, mode))
    ref = _np(grid_sample_onehot(jnp.asarray(img), jnp.asarray(pts), padding_mode=mode,
                                 banded=True, block_hw=256, block_p=128))
    got_bf = _np(bilinear_sample(_t(img).bfloat16(), _t(pts), mode))
    assert bilinear_sample.launches == 0
    with pytest.raises(TypeError):   # K1 takes bf16 tables only, on any device
        bilinear_sample(_t(img), _t(pts), mode)
    np.testing.assert_allclose(got_bf, ref, atol=2e-2)
    assert np.abs(got_bf - ref).mean() / (np.abs(ref).mean() + 1e-6) < 5e-3


def _split_inputs(rng, T=40, widths=(32, 32, 32, 16)):
    parts = [rng.randn(2, T, w).astype(np.float32) for w in widths]
    parts.append(np.tanh(rng.randn(2, T, 3)).astype(np.float32))
    K = sum(widths) + 3
    kernel = (rng.randn(K, 64) / np.sqrt(K)).astype(np.float32)
    bias = (rng.randn(64) * 0.1).astype(np.float32)
    fk = (rng.randn(64, 16) / 8).astype(np.float32)
    return parts, kernel, bias, fk


def test_split_dense_relu_plain_matches_jax_f32():
    parts, kernel, bias, fk = _split_inputs(np.random.RandomState(8))
    out, k = split_dense_relu([_t(p) for p in parts], _t(kernel), _t(bias), _t(fk))
    assert split_dense_relu.launches == 0
    jout, jk = j_split_dense_relu(tuple(jnp.asarray(p) for p in parts), kernel, bias, fk, jnp.float32)
    _close(out, jout, atol=1e-6, rtol=1e-5)
    _close(k, jk, atol=1e-6, rtol=1e-5)


def test_split_dense_relu_plain_matches_jax_bf16():
    parts, kernel, bias, fk = _split_inputs(np.random.RandomState(9))
    tparts = [_t(p).bfloat16() for p in parts]
    out, k = split_dense_relu_plain(tparts, _t(kernel), _t(bias), _t(fk))
    assert out.dtype == torch.bfloat16 and k.dtype == torch.bfloat16
    jparts = tuple(jnp.asarray(p).astype(jnp.bfloat16) for p in parts)
    jout, jk = j_split_dense_relu(jparts, kernel, bias, fk, jnp.bfloat16)
    for a, b in ((out, jout), (k, jk)):
        a, b = _np(a), _np(b)
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-6) < 1e-2


@pytest.mark.parametrize("vsum", [None, 2])
def test_weighted_sum_plain_matches_jax(vsum):
    rng = np.random.RandomState(10)
    R, S, N, C = 2, 8, 48, 256   # N not a block multiple
    pre = jnp.asarray(rng.randn(R, S * N, C).astype(np.float32)).astype(jnp.bfloat16)
    w = rng.rand(R, N, S).astype(np.float32)
    ref = j_weighted_sum(pre, jnp.asarray(w), S, vsum=vsum)
    got = weighted_sum_smaj(_t(_np(pre)).bfloat16(), _t(w), S, vsum=vsum)
    assert weighted_sum_smaj.launches == 0
    _close(got, ref, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("case", ["table_dtype", "grid_dtype", "padding", "batch", "grid_width", "table_rank"])
def test_bilinear_sample_rejects_bad_arguments(case):
    """K1's argument checks, which run before the wrapper picks the plain
    version or the kernel: dtypes (TypeError), padding and shapes
    (ValueError)."""
    img = torch.zeros(2, 8, 8, 16, dtype=torch.bfloat16)
    pts = torch.zeros(2, 10, 2)
    mode, err = "zeros", ValueError
    if case == "table_dtype":
        img, err = img.float(), TypeError
    elif case == "grid_dtype":
        pts, err = pts.double(), TypeError
    elif case == "padding":
        mode = "reflection"
    elif case == "batch":
        pts = pts[:1]
    elif case == "grid_width":
        pts = torch.zeros(2, 10, 3)
    else:
        img = img[0]
    before = bilinear_sample.launches
    with pytest.raises(err):
        bilinear_sample(img, pts, mode)
    assert bilinear_sample.launches == before


# ------------------------------------------- kernels vs plain, on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_bilinear_sample_kernel_matches_plain(cuda, mode):
    g = torch.Generator(device=cuda).manual_seed(0)
    for hw, C in ((16, 256), (256, 64)):
        img = torch.randn(2, hw, hw, C, device=cuda, generator=g).bfloat16()
        pts = torch.rand(2, 3000, 2, device=cuda, generator=g) * 2.4 - 1.2
        torch.testing.assert_close(bilinear_sample(img, pts, mode),
                                   bilinear_sample_plain(img, pts, mode), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [0, 77, 128, 129, 600, 40000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_dense_relu_kernel_matches_plain(cuda, dtype, rows):
    """Row counts: none, one partial 128-row tile, one exact tile, a tile
    and one row, and many tiles with a ragged last one; even counts as two
    view rows, as the model lays them out."""
    g = torch.Generator(device=cuda).manual_seed(1)
    lead = (2, rows // 2) if rows % 2 == 0 else (1, rows)
    parts = [torch.randn(*lead, w, device=cuda, generator=g).to(dtype) for w in (256, 256, 256, 64)]
    parts.append(torch.tanh(torch.randn(*lead, 3, device=cuda, generator=g)).to(dtype))
    kernel = torch.randn(835, 832, device=cuda, generator=g) / 835 ** 0.5
    bias = torch.randn(832, device=cuda, generator=g) * 0.1
    fk = torch.randn(832, 128, device=cuda, generator=g) / 832 ** 0.5
    out, k = split_dense_relu(parts, kernel, bias, fk)
    pout, pk = split_dense_relu_plain(parts, kernel, bias, fk)
    tol = dict(atol=3e-2, rtol=1e-2) if dtype == torch.bfloat16 else dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(out.float(), pout.float(), **tol)
    torch.testing.assert_close(k.float(), pk.float(), **tol)


@pytest.mark.cuda
def test_weighted_sum_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    pre = torch.randn(2, 16 * 1000, 832, device=cuda, generator=g).bfloat16()
    w = torch.rand(2, 1000, 16, device=cuda, generator=g)
    for vsum in (None, 2):
        torch.testing.assert_close(weighted_sum_smaj(pre, w, 16, vsum=vsum),
                                   weighted_sum_plain(pre, w, 16, vsum=vsum), atol=1e-4, rtol=1e-5)


def _ray_major_points(g, B, rays, S, shift, dev):
    """(B, rays * S, 2) points as training lays them: token n*S + s, each
    ray a segment across the image (``shift`` moves its start off it)."""
    start = torch.rand(B, rays, 1, 2, device=dev, generator=g) * 0.4 - 1.0 - shift
    end = torch.rand(B, rays, 1, 2, device=dev, generator=g) * 0.4 + 0.6
    t = torch.linspace(0, 1, S, device=dev)[None, None, :, None]
    return (start + (end - start) * t).reshape(B, rays * S, 2).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_bilinear_sample_kernel_training_levels(cuda, mode):
    """K1 as training calls it: the three small levels (C 256) at ray-major
    points (64 samples a ray, consecutive samples in the same or the next
    cell), bit for bit its plain version."""
    g = torch.Generator(device=cuda).manual_seed(4)
    pts = _ray_major_points(g, 3, 192, 64, 0.0 if mode == "border" else 0.3, cuda)
    for hw in (16, 32, 64):
        img = torch.randn(3, hw, hw, 256, device=cuda, generator=g).bfloat16()
        before = bilinear_sample.launches
        got = bilinear_sample(img, pts, mode)
        assert bilinear_sample.launches == before + 1
        torch.testing.assert_close(got, bilinear_sample_plain(img, pts, mode), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 63, 65, 515])
@pytest.mark.parametrize("C", [24, 256])
def test_bilinear_sample_kernel_ragged_tiles(cuda, P, C):
    """Point counts that end in a partial tile of the kernel (64 points a
    block) or fill less than one, at a C whose C / 8 is a power of two and
    one where it is not, both paddings; bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(P + C)
    img = torch.randn(2, 11, 13, C, device=cuda, generator=g).bfloat16()
    pts = torch.rand(2, P, 2, device=cuda, generator=g) * 2.4 - 1.2
    for mode in ("border", "zeros"):
        torch.testing.assert_close(bilinear_sample(img, pts, mode), bilinear_sample_plain(img, pts, mode),
                                   atol=0, rtol=0)


@pytest.mark.cuda
def test_bilinear_sample_kernel_scrubs_nonfinite(cuda):
    """Zeros padding: runs of NaN, +-Inf, huge and far-off-image points among
    in-image ones give the plain version's output bit for bit: zeros where
    no corner is in the image."""
    g = torch.Generator(device=cuda).manual_seed(6)
    img = torch.randn(2, 16, 16, 256, device=cuda, generator=g).bfloat16()
    pts = torch.rand(2, 64, 2, device=cuda, generator=g) * 2.0 - 1.0
    bad = torch.tensor([[float("nan"), 0.0], [0.0, float("inf")], [float("-inf"), float("nan")], [1e30, -1e30],
                        [3.0, 0.5], [-1.2, -1.1], [0.1, 1.07]], device=cuda)
    pts[0, 3:10] = bad
    pts[1, 16:23] = bad.flip(0)
    pts[1, 40::3] = bad[0]
    got = bilinear_sample(img, pts, "zeros")
    torch.testing.assert_close(got, bilinear_sample_plain(img, pts, "zeros"), atol=0, rtol=0)
    assert (got[0, 3:7] == 0).all()
