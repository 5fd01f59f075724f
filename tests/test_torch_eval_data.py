"""The port's scene readers, loader, metrics and evaluation entry on the CPU.

The readers (``coponerf_tpu_torch/data/``) and the loader are copies of the
JAX package's numpy pipeline: on fabricated scene archives (the fixture of
``tests/test_data.py``) they give the same items, poses, intrinsics and
overlaps exactly.  ``eval/metrics.py`` equals the JAX package's exactly.
``python -m coponerf_tpu_torch.test`` runs end to end with ``--device
cpu`` on a small fabricated archive with a narrow model (swapped in by
monkeypatching, the entry has no such flag) and a checkpoint written by
the port.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.io import savemat

from coponerf_tpu.data import acid as j_acid
from coponerf_tpu.data import realestate as j_re
from coponerf_tpu.data.loader import PrefetchLoader as JPrefetchLoader
from coponerf_tpu.eval import metrics as JM
from coponerf_tpu_torch import test as entry
from coponerf_tpu_torch.data import acid as t_acid
from coponerf_tpu_torch.data import realestate as t_re
from coponerf_tpu_torch.data.loader import PrefetchLoader, make_loader
from coponerf_tpu_torch.data.scene_dataset import SceneDatasetConfig, VisSceneDataset
from coponerf_tpu_torch.eval import metrics as TM

torch.set_num_threads(2)


def _fabricate(root, n_scenes, n_frames, hw, seed=0):
    """Scene directories of random uint8 frames with a slow dolly, their
    .mat pose table and an overlap table."""
    img_root = root / "train"
    img_root.mkdir()
    rng = np.random.RandomState(seed)
    pose_tables = {}
    for s in range(n_scenes):
        name = f"scene{s:03d}"
        sdir = img_root / name
        sdir.mkdir()
        frames, rows = {}, []
        for i in range(n_frames):
            ts = 1000 * i
            frames[f"{ts}.png"] = rng.randint(0, 255, (*hw, 3), np.uint8)
            w2c = np.eye(4)
            w2c[0, 3] = 0.01 * i
            rows.append([ts, 0.9, 0.9, 0.5, 0.5, 0, 0, *w2c[:3].reshape(-1)])
        np.savez(sdir / "data.npz", **frames)
        pose_tables[name] = np.array(rows, np.float64)
    pose_path = root / "train.mat"
    savemat(pose_path, pose_tables)
    overlap = root / "overlap.npy"
    np.save(overlap, np.linspace(0.2, 0.9, n_scenes).astype(np.float32)[:, None])
    return str(img_root), str(pose_path), str(overlap)


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    """Two scenes of 160 frames at the datasets' 256 x 455 (as tests/test_data.py)."""
    return _fabricate(tmp_path_factory.mktemp("scenes"), 2, 160, (256, 455))


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=path)


@pytest.mark.parametrize("name", ["realestate", "acid"])
def test_vis_items_match_jax(fake_root, name):
    """Eval triplets: images, poses, intrinsics, uv and overlap, exactly."""
    img_root, pose_root, overlap = fake_root
    j_cls, t_cls = (j_re.RealEstate10kVis, t_re.RealEstate10kVis) if name == "realestate" else (
        j_acid.ACIDVis, t_acid.ACIDVis)
    jd = j_cls(img_root, pose_root, overlap=overlap, n_skip=50)
    td = t_cls(img_root, pose_root, overlap=overlap, n_skip=50)
    assert len(jd) == len(td) == 2
    for i in range(2):
        _assert_same(td[i], jd[i])


@pytest.mark.parametrize("name", ["realestate", "acid"])
def test_train_items_match_jax(fake_root, name):
    """Train sampling from the same seeds (the dataset's own and numpy's,
    which draws the query rays) gives the same pairs and rays."""
    img_root, pose_root, _ = fake_root
    j_cls, t_cls = (j_re.RealEstate10k, t_re.RealEstate10k) if name == "realestate" else (j_acid.ACID, t_acid.ACID)
    jd = j_cls(img_root, pose_root, query_sparsity=48, seed=3)
    td = t_cls(img_root, pose_root, query_sparsity=48, seed=3)
    for i in (0, 1, 1):
        np.random.seed(10 + i)
        ref = jd[i]
        np.random.seed(10 + i)
        _assert_same(td[i], ref)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_prefetch_loader_matches_jax(fake_root, num_workers):
    """One in-order eval epoch, serial and through spawned workers, with the
    tail kept: the same collated batches as the JAX package's loader."""
    img_root, pose_root, overlap = fake_root
    kw = dict(batch_size=1, shuffle=False, num_workers=num_workers, drop_last=False)
    ref = list(iter(JPrefetchLoader(j_re.RealEstate10kVis(img_root, pose_root, overlap=overlap), **kw)))
    got = list(iter(PrefetchLoader(t_re.RealEstate10kVis(img_root, pose_root, overlap=overlap), **kw)))
    assert len(got) == len(ref) == 2
    _assert_same(got, ref)


def test_shuffled_serial_loader_matches_jax(fake_root):
    """The shuffled single-process stream (``make_loader``, no workers)
    crosses an epoch in the same order as the JAX package's."""
    img_root, pose_root, _ = fake_root
    kw = dict(batch_size=1, shuffle=True, seed=4, num_workers=0)
    ref_ds = j_re.RealEstate10k(img_root, pose_root, query_sparsity=16, seed=0)
    got_ds = t_re.RealEstate10k(img_root, pose_root, query_sparsity=16, seed=0)
    np.random.seed(5)
    ref_it = iter(JPrefetchLoader(ref_ds, **kw))
    ref = [next(ref_it) for _ in range(3)]
    np.random.seed(5)
    got_it = make_loader(got_ds, **kw)
    got = [next(got_it) for _ in range(3)]
    _assert_same(got, ref)


def test_scene_cache_raises(tmp_path):
    """A native scene.cache file is refused (the cache is not ported), unless
    the dataset is built with use_cache=False."""
    img_root, pose_root, _ = _fabricate(tmp_path, 1, 24, (32, 57))
    (tmp_path / "train" / "scene000" / "scene.cache").write_bytes(b"")
    cfg = SceneDatasetConfig(img_root=img_root, pose_root=pose_root, image_size=32, base_hw=(32, 57), min_frames=20)
    with pytest.raises(NotImplementedError):
        VisSceneDataset(cfg)[0]
    item, _, _ = VisSceneDataset(dataclasses.replace(cfg, use_cache=False))[0]
    assert item["context"]["rgb"].shape == (2, 32, 32, 3)


def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    a, b = rng.rand(2, 24, 24, 3), rng.rand(2, 24, 24, 3)
    for x, y in ((a[0], b[0]), (a[1], a[1]), (a[0], np.clip(a[0] + 0.05, 0, 1))):
        assert TM.psnr(x, y) == JM.psnr(x, y)
        assert TM.ssim(x, y) == JM.ssim(x, y)
    assert TM.ssim(a[0, ..., 0], b[0, ..., 0]) == JM.ssim(a[0, ..., 0], b[0, ..., 0])
    q = [np.linalg.qr(rng.randn(3, 3))[0] for _ in range(4)]
    R1, R2 = np.stack(q[:2]), np.stack(q[2:])
    np.testing.assert_array_equal(TM.rotation_geodesic(R1, R2), JM.rotation_geodesic(R1, R2))
    t1, t2 = rng.randn(5, 3), rng.randn(5, 3)
    _assert_same(TM.translation_error(t1, t2), JM.translation_error(t1, t2))
    for ov in (0.1, 0.5, 0.75, 0.76, 1.0):
        assert TM.overlap_bin(ov) == JM.overlap_bin(ov)
    ta, ja = TM.MetricAccumulator(), JM.MetricAccumulator()
    for i, ov in enumerate((0.2, 0.6, 0.9, 0.95)):
        for acc in (ta, ja):
            acc.add(TM.overlap_bin(ov), psnr=20.0 + i, ssim=0.5 + 0.1 * i, lpips=None)
    assert ta.summary() == ja.summary()
    assert ta.format() == ja.format()
    assert TM.lpips_vgg(a[0], b[0]) is None
    with pytest.raises(NotImplementedError):
        TM.lpips_vgg(a[0], b[0], "lpips_vgg.npz")


# --------------------------------------------------------- the entry point --

NARROW = dict(npoints=4, ufc_layer_nums=(1, 1, 1), mask_upsample=32)


@pytest.fixture(scope="module")
def small_archive(tmp_path_factory):
    """A 32 x 57-frame archive (32^2 images after the square crop), and a
    checkpoint of a narrow seeded model written by the port."""
    from coponerf_tpu_torch.config import Config, ModelConfig
    from coponerf_tpu_torch.models import CoPoNeRF
    from coponerf_tpu_torch.training import checkpoint, trainer
    from coponerf_tpu_torch.utils.init import init_weights

    root = tmp_path_factory.mktemp("small")
    img_root, pose_root, overlap = _fabricate(root, 2, 30, (32, 57))
    ckpts = {}
    for fast in (False, True):
        mcfg = ModelConfig(fast_sampling=fast, compute_dtype="bfloat16" if fast else "float32", **NARROW)
        state = trainer.create_train_state(Config(model=mcfg), 32, "cpu",
                                           model=init_weights(CoPoNeRF(mcfg, image_size=32), seed=0))
        ckpts[fast] = checkpoint.save(str(root / f"ckpt_{fast}"), state, step=0)
    return img_root, pose_root, overlap, ckpts


@pytest.fixture
def narrow_entry(monkeypatch):
    """The entry with the narrow model and 32^2 scene readers."""
    from coponerf_tpu_torch.config import ModelConfig

    def small_vis(img_root, pose_root, overlap=None, n_skip=50, num_ctxt_views=2):
        cfg = SceneDatasetConfig(img_root=img_root, pose_root=pose_root, num_ctxt_views=num_ctxt_views,
                                 image_size=32, base_hw=(32, 57), min_frames=20)
        return VisSceneDataset(cfg, n_skip=n_skip, overlap=overlap)

    monkeypatch.setattr(entry, "ModelConfig", lambda **kw: ModelConfig(**kw, **NARROW))
    monkeypatch.setattr(t_re, "RealEstate10kVis", small_vis)
    return entry


@pytest.mark.parametrize("fast", [False, True])
def test_entry_evaluates_on_cpu(small_archive, narrow_entry, capsys, fast):
    img_root, pose_root, overlap, ckpts = small_archive
    argv = ["--data_root", img_root, "--pose_root", pose_root, "--overlap", overlap, "--checkpoint_path",
            ckpts[fast], "--device", "cpu", "--max_batches", "1", "--allow_missing_lpips", "--batch_size", "1",
            "--chunk", "400"] + (["--fast"] if fast else [])
    with pytest.warns(UserWarning, match="LPIPS"):
        assert narrow_entry.main(argv) == 0
    out = capsys.readouterr().out
    last = out.strip().splitlines()[-2:]
    assert last[0].startswith("all: ") and last[1].startswith("small: "), out   # scene 0's overlap is 0.2
    vals = dict(kv.split(": ") for kv in last[0][len("all: "):].split(", "))
    for k in ("psnr_avg", "ssim_avg", "rot_avg", "trans_avg", "angle_trans_avg", "rays_per_sec_avg"):
        assert np.isfinite(float(vals[k])), k


def test_entry_refusals(small_archive, narrow_entry, monkeypatch):
    """No CUDA and no --device cpu: exit 2.  A .pth checkpoint, no
    checkpoint, or no LPIPS decision: refused with a message."""
    img_root, pose_root, _, ckpts = small_archive
    base = ["--data_root", img_root, "--pose_root", pose_root]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert narrow_entry.main(base + ["--checkpoint_path", ckpts[False], "--allow_missing_lpips"]) == 2
    for extra, match in ((["--checkpoint_path", "w.pth", "--allow_missing_lpips"], "ROADMAP"),
                         (["--allow_missing_lpips"], "checkpoint_path"),
                         (["--checkpoint_path", ckpts[False]], "lpips")):
        with pytest.raises(SystemExit, match=match):
            narrow_entry.main(base + extra + ["--device", "cpu"])
