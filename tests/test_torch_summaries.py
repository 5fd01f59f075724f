"""The port's summaries (``coponerf_tpu_torch/training/summaries.py``)
against the JAX package's (``coponerf_tpu/training/summaries.py``, which
draws with cv2 and colours depth with matplotlib), on the CPU.

Bounds: every scalar, and the prediction, depth, context, query and
flow-warped panels, at 1e-5; the masked warped panels' outline (a
4-neighbour boundary against cv2.findContours + drawContours) equal;
``jet`` against matplotlib at 1e-6; the epipolar lines' coefficients
against cv2.computeCorrespondEpilines at 1e-5.  The epipolar panels are
drawn with distance masks where cv2 rasterises: they must be identical
away from the strokes, and the stroke masks (pixels that differ from the
undrawn panel) must overlap with an IoU of at least 0.9.
"""

import numpy as np
import pytest
import torch

from coponerf_tpu.training import summaries as JS
from coponerf_tpu_torch.training import summaries as TS

cv2 = pytest.importorskip("cv2")
plt = pytest.importorskip("matplotlib.pyplot")


class RecordingLogger:
    def __init__(self):
        self.scalars, self.images = {}, {}

    def log(self, step, metrics):
        self.scalars.update(metrics)

    def log_image(self, step, tag, img):
        self.images[tag] = np.asarray(img)


def _pose(rng, rot=0.1, trans=1.0):
    from scipy.spatial.transform import Rotation

    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = Rotation.from_rotvec(rng.randn(3) * rot).as_matrix()
    p[:3, 3] = rng.randn(3) * trans
    return p


def _inputs(seed, B=2, H=64, S=6):
    rng = np.random.RandomState(seed)
    K = np.array([[0.9 * H, 0, H / 2, 0], [0, 0.9 * H, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    model_input = {"context": {"rgb": rng.rand(B, 2, H, H, 3).astype(np.float32) * 2 - 1,
                               "intrinsics": np.tile(K, (B, 2, 1, 1))}}
    gt = {"rgb": rng.rand(B, 1, H * H, 3).astype(np.float32) * 2 - 1}
    at = rng.rand(B * 2, H * H, S).astype(np.float32)
    yy, xx = np.mgrid[0:H // 4, 0:H // 4]
    flow = np.stack([np.sin(xx / 3.0 + s) * 2 + rng.randn(*xx.shape) * 0.3 for s in range(2 * B)])
    flow = flow.reshape(B, 2, H // 4, H // 4).astype(np.float32)
    out = {
        "rgb": rng.randn(B, 1, H * H, 3).astype(np.float32) * 0.8,
        "depth_ray": rng.rand(B, H * H).astype(np.float32) * 12,
        "at_wt": at / at.sum(-1, keepdims=True),
        "rel_pose": np.stack([_pose(rng) for _ in range(B)]),
        "gt_rel_pose": np.stack([_pose(rng) for _ in range(B)]),
        "flow": [flow, -flow[:, ::-1].copy()],
    }
    return model_input, gt, out


def test_jet_matches_matplotlib():
    x = np.concatenate([np.random.RandomState(0).rand(4096), [0.0, 1.0, 0.5, 1 / 256, 255 / 256, 0.35, 0.66]])
    np.testing.assert_allclose(TS.jet(x), plt.get_cmap("jet")(x)[..., :3], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(TS.jet(np.array([np.nan])), [[0.0, 0.0, 0.0]])


@pytest.fixture(scope="module", params=[0, 1])
def logged(request):
    mi, gt, out = _inputs(request.param)
    j, t = RecordingLogger(), RecordingLogger()
    JS.img_summaries(j, mi, gt, out, 3, prefix="val_", img_shape=(64, 64))
    tout = dict(out, flow=[torch.from_numpy(f) for f in out["flow"]], at_wt=torch.from_numpy(out["at_wt"]))
    TS.img_summaries(t, mi, gt, tout, 3, prefix="val_", img_shape=(64, 64))
    return j, t


def test_scalars_match_jax(logged):
    j, t = logged
    assert sorted(t.scalars) == sorted(j.scalars)
    for k, v in j.scalars.items():
        assert t.scalars[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


@pytest.mark.parametrize("tag", ["predictions", "depth_images", "context_images", "query_images", "warped_img",
                                 "warped_img_flip"])
def test_panels_match_jax(logged, tag):
    j, t = logged
    assert t.images["val_" + tag].shape == j.images["val_" + tag].shape
    np.testing.assert_allclose(t.images["val_" + tag], j.images["val_" + tag], atol=1e-5, rtol=0, err_msg=tag)


@pytest.mark.parametrize("tag", ["masked_warped_img", "masked_warped_img_flip"])
def test_masked_panels_match_jax(logged, tag):
    """The overlay blend and its outline: equal panels but for f32
    round-off in the warped image under them (1e-5 on [0, 1]) and a
    uint8 step where that round-off crosses an integer."""
    j, t = logged
    a, b = t.images["val_" + tag], j.images["val_" + tag]
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max() <= 1 / 255 + 1e-6 and (d > 1e-5).mean() < 1e-3, (d.max(), (d > 1e-5).mean())


def test_epipolar_lines_match_cv2():
    rng = np.random.RandomState(2)
    K = np.tile(np.array([[200, 0, 128, 0], [0, 200, 128, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32), (3, 1, 1))
    for F in TS.fundamental_from_pose(K, K, np.stack([_pose(rng) for _ in range(3)])):
        want = cv2.computeCorrespondEpilines(TS._PTS.reshape(-1, 1, 2).astype(np.float32), 1, F).reshape(-1, 3)
        np.testing.assert_allclose(TS.epipolar_lines(F, TS._PTS), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epipolar_panels_against_cv2(seed):
    """256^2 images (the keypoints' grid), estimated and ground-truth poses."""
    rng = np.random.RandomState(seed)
    B = 2
    img1, img2 = (rng.rand(B, 256, 256, 3).astype(np.float32) * 2 - 1 for _ in range(2))
    K = np.tile(np.array([[230, 0, 128, 0], [0, 230, 128, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32), (B, 1, 1))
    est, gt = (np.stack([_pose(rng, 0.05, 0.5) for _ in range(B)]) for _ in range(2))
    got, want = TS.epipolar_panels(img1, K, img2, K, est, gt), JS.epipolar_panels(img1, K, img2, K, est, gt)
    undrawn = np.concatenate([((img1 + 1) * 127.5).astype(np.uint8), ((img2 + 1) * 127.5).astype(np.uint8)], axis=2)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.uint8
        sg, sw = (g != undrawn).any(-1), (w != undrawn).any(-1)
        away = ~(sg | sw)
        np.testing.assert_array_equal(g[away], w[away])
        iou = (sg & sw).sum() / max((sg | sw).sum(), 1)
        assert iou >= 0.9, iou


def test_mask_outline_matches_cv2_contours():
    rng = np.random.RandomState(4)
    for _ in range(5):
        m = np.zeros((48, 48), bool)
        for _ in range(4):
            y, x, h, w = rng.randint(0, 40, 4)
            m[y:y + h // 2 + 2, x:x + w // 2 + 2] = True
        m[rng.randint(0, 48, 20), rng.randint(0, 48, 20)] ^= True
        img = rng.randint(0, 255, (48, 48, 3), np.uint8)
        np.testing.assert_array_equal(TS._overlay_mask(img, m), JS._overlay_mask(img, m))
