"""Camera-path rendering of the port (``coponerf_tpu_torch/eval/trajectory.py``,
``CameraPathDataset``, ``python -m coponerf_tpu_torch.render_path``)
against the JAX package's on the CPU.

``make_circle`` and ``interpolate_poses`` equal JAX's bit for bit;
``CameraPathDataset`` items equal JAX's exactly on a fabricated archive;
``render_trajectory`` and ``render_scene_path`` on narrow weights (the
exact config, 32^2, three frames, 512-ray chunks) match JAX's at the exact
slice's 1e-4 (``tests/test_torch_slice_exact.py``); the entry writes PNGs
that decode (PIL) to the frames ``render_trajectory`` gives, exactly.
The fabricated scene's cameras pan slowly and move off whole-pixel steps:
with cameras a whole pixel apart, rays that project exactly onto a
context image's border turn white in one package and not in the other on
f32 round-off (the valid mask is a strict comparison).  The JAX references
are computed once per module.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import savemat

from coponerf_tpu.config import ModelConfig as JaxModelConfig
from coponerf_tpu.data.scene_dataset import CameraPathDataset as JCameraPathDataset
from coponerf_tpu.data.synthetic import make_batch
from coponerf_tpu.eval import trajectory as jtraj
from coponerf_tpu.models import CoPoNeRF as JaxCoPoNeRF
from coponerf_tpu.utils.fast_init import fast_init
from coponerf_tpu_torch import render_path
from coponerf_tpu_torch.config import ModelConfig
from coponerf_tpu_torch.data.scene_dataset import CameraPathDataset, SceneDatasetConfig
from coponerf_tpu_torch.eval import trajectory as ttraj
from coponerf_tpu_torch.models import CoPoNeRF
from coponerf_tpu_torch.utils.convert import convert
from coponerf_tpu_torch.utils.init import init_weights

torch.set_num_threads(2)

IMG = 32
CHUNK = 512
N_FRAMES = 3
CFG_KW = dict(npoints=4, ufc_layer_nums=(1, 1, 1), mask_upsample=IMG)
TOL = dict(atol=1e-4, rtol=1e-4)


def test_make_circle_matches_jax():
    for n, r in ((1, 0.1), (30, 0.1), (7, 0.25)):
        np.testing.assert_array_equal(ttraj.make_circle(n, r), jtraj.make_circle(n, r))


def test_interpolate_poses_matches_jax():
    rng = np.random.RandomState(0)
    for n in (1, 2, 9):
        a, b = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
        for m in (a, b):
            m[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0] * np.sign(np.linalg.det(np.linalg.qr(rng.randn(3, 3))[0]))
            m[:3, 3] = rng.randn(3)
        got, want = ttraj.interpolate_poses(a, b, n), jtraj.interpolate_poses(a, b, n)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _fabricate(root, n_frames=24, hw=(32, 57)):
    img_root = root / "scenes"
    sdir = img_root / "scene000"
    sdir.mkdir(parents=True)
    rng = np.random.RandomState(3)
    frames, rows = {}, []
    for i in range(n_frames):
        frames[f"{1000 * i}.png"] = rng.randint(0, 255, (*hw, 3), np.uint8)
        # a dolly with a slow pan, off any pixel-exact alignment
        th = 0.0031 * i
        w2c = np.eye(4)
        w2c[0, 0], w2c[0, 2], w2c[2, 0], w2c[2, 2] = np.cos(th), np.sin(th), -np.sin(th), np.cos(th)
        w2c[:3, 3] = (0.0137 * i, 0.0041 * i, 0.0093 * i)
        rows.append([1000 * i, 0.9, 0.9, 0.5, 0.5, 0, 0, *w2c[:3].reshape(-1)])
    np.savez(sdir / "data.npz", **frames)
    savemat(root / "poses.mat", {"scene000": np.array(rows, np.float64)})
    return SceneDatasetConfig(img_root=str(img_root), pose_root=str(root / "poses.mat"), image_size=IMG,
                              base_hw=hw, min_frames=20)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    batch_np, _ = make_batch(batch_size=1, image_size=IMG, n_rays=16, seed=0)
    jm = JaxCoPoNeRF(JaxModelConfig(**CFG_KW))
    variables = fast_init(jm, jax.tree.map(jnp.asarray, batch_np), val=False, train=False)
    port = CoPoNeRF(ModelConfig(**CFG_KW), image_size=IMG).eval()
    port.load_state_dict(convert(jax.tree.map(np.asarray, variables)), strict=True)
    cfg = _fabricate(tmp_path_factory.mktemp("path"))
    import coponerf_tpu.data.scene_dataset as jsd

    item = JCameraPathDataset(jsd.SceneDatasetConfig(**dataclasses.asdict(cfg)), max_frames=N_FRAMES + 1)[0]
    ref = {
        "trajectory": jtraj.render_trajectory(jm, variables, jax.tree.map(jnp.asarray, batch_np),
                                              n_frames=N_FRAMES, image_size=IMG, chunk=CHUNK),
        "scene_path": jtraj.render_scene_path(jm, variables, item, image_size=IMG, chunk=CHUNK),
    }
    return port, batch_np, cfg, item, ref, jax.tree.map(np.asarray, variables)


def test_camera_path_items_match_jax(setup):
    _, _, cfg, item, _, _ = setup
    got = CameraPathDataset(cfg, max_frames=N_FRAMES + 1)[0]
    assert sorted(got) == sorted(item)
    for part in item:
        assert sorted(got[part]) == sorted(item[part])
        for k, v in item[part].items():
            assert got[part][k].dtype == v.dtype and got[part][k].shape == v.shape, (part, k)
            np.testing.assert_array_equal(got[part][k], v, err_msg=f"{part}/{k}")
    assert got["query_path"]["cam2world"].shape == (N_FRAMES, 4, 4)


def test_render_trajectory_matches_jax(setup):
    port, batch_np, _, _, ref, _ = setup
    got = ttraj.render_trajectory(port, batch_np, n_frames=N_FRAMES, image_size=IMG, chunk=CHUNK)
    assert got.shape == (N_FRAMES, IMG, IMG, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref["trajectory"], **TOL)


def test_render_trajectory_circle_poses(setup, monkeypatch):
    """With ``circle_radius`` the frames are rendered at JAX's path: the
    interpolated poses with the circle added to their translations."""
    port, batch_np, _, _, _, _ = setup
    seen = []
    monkeypatch.setattr(ttraj, "render_poses", lambda model, batch, state, poses, chunk: seen.append(poses)
                        or torch.zeros(len(poses), IMG * IMG, 3))
    ttraj.render_trajectory(port, batch_np, n_frames=5, image_size=IMG, chunk=CHUNK, circle_radius=0.05)
    c2w = batch_np["context"]["cam2world"][0]
    want = jtraj.interpolate_poses(c2w[0], c2w[1], 5).copy()
    want[:, :3, 3] += jtraj.make_circle(5, 0.05)
    np.testing.assert_array_equal(seen[0], want)


def test_render_scene_path_matches_jax(setup):
    port, _, _, item, ref, _ = setup
    got = ttraj.render_scene_path(port, item, image_size=IMG, chunk=CHUNK)
    assert got.shape == (N_FRAMES, IMG, IMG, 3)
    np.testing.assert_allclose(got, ref["scene_path"], **TOL)
    first = ttraj.render_scene_path(port, item, image_size=IMG, chunk=300, max_frames=1)
    np.testing.assert_allclose(first, got[:1], atol=1e-5, rtol=1e-5)


def test_render_path_entry_writes_png_frames(tmp_path, monkeypatch):
    """``--seed`` weights on a synthetic 32^2 scene, the fast config: the
    PNGs decode to the frames of ``render_trajectory`` on the same model."""
    from PIL import Image

    narrow = lambda **kw: ModelConfig(**{**kw, **CFG_KW})
    monkeypatch.setattr(render_path, "ModelConfig", narrow)
    out = tmp_path / "frames"
    assert render_path.main(["--seed", "1", "--image_size", str(IMG), "--n_frames", "2", "--cf", "4,2",
                             "--device", "cpu", "--out", str(out)]) == 0
    cfg = narrow(fast_sampling=True, compute_dtype="bfloat16", coarse_samples=4, fine_samples=2)
    model = init_weights(CoPoNeRF(cfg, image_size=IMG).eval(), seed=1)
    batch, _ = make_batch(batch_size=1, image_size=IMG, n_rays=16, seed=0)
    frames = ttraj.render_trajectory(model, batch, n_frames=2, image_size=IMG, chunk=IMG * IMG)
    u8 = np.clip((frames * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    for i in range(2):
        decoded = np.asarray(Image.open(out / f"frame_{i:03d}.png"))
        assert decoded.dtype == np.uint8 and decoded.shape == (IMG, IMG, 3)
        np.testing.assert_array_equal(decoded, u8[i])
    assert not os.path.exists(out / "frame_002.png")


def test_render_path_entry_takes_a_jax_npz(setup, tmp_path, monkeypatch):
    """``--checkpoint`` of a JAX ``.npz`` (the fixture's JAX weights, written
    by the JAX package's ``save``): the PNGs are the frames of
    ``render_trajectory`` on the port model holding those weights."""
    import types

    from PIL import Image

    from coponerf_tpu.training.checkpoint import save as jax_save

    jm_variables = setup[-1]
    npz = jax_save(str(tmp_path), types.SimpleNamespace(**jm_variables), step=3)
    narrow = lambda **kw: ModelConfig(**{**kw, **CFG_KW})
    monkeypatch.setattr(render_path, "ModelConfig", narrow)
    out = tmp_path / "frames"
    assert render_path.main(["--checkpoint", npz, "--image_size", str(IMG), "--n_frames", "2", "--cf", "4,2",
                             "--device", "cpu", "--out", str(out)]) == 0
    model = CoPoNeRF(narrow(fast_sampling=True, compute_dtype="bfloat16", coarse_samples=4, fine_samples=2),
                     image_size=IMG).eval()
    model.load_state_dict(convert(jm_variables), strict=True)
    batch, _ = make_batch(batch_size=1, image_size=IMG, n_rays=16, seed=0)
    frames = ttraj.render_trajectory(model, batch, n_frames=2, image_size=IMG, chunk=IMG * IMG)
    u8 = np.clip((frames * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    for i in range(2):
        np.testing.assert_array_equal(np.asarray(Image.open(out / f"frame_{i:03d}.png")), u8[i])


def test_render_path_entry_refusals(tmp_path, monkeypatch):
    with pytest.raises(SystemExit):
        render_path.main(["--out", str(tmp_path)])            # neither --checkpoint nor --seed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert render_path.main(["--seed", "0", "--out", str(tmp_path)]) == 2
