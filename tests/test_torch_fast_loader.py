"""The port's native scene cache (``coponerf_tpu_torch/data/fast_loader.py``)
and the readers' resize, on the CPU.

Mirrors ``tests/test_fast_loader.py`` (round trip, truncated files refused,
the fused crop + resize held to cv2 at atol 2e-2 with a mean error under
5e-3: cv2 interpolates in fixed point), builds the library under the
port's git-ignored ``_build/`` (never under ``runtime/``), and holds the
readers with a ``scene.cache`` to the JAX package's readers on the same
cache, item for item, exactly.  The JAX readers are given the port's build
of the same source, so this file builds nothing under ``runtime/``.  The
readers' numpy ``bilinear_resize`` (their resize where cv2 is missing) is
held to ``cv2.resize`` at the same 2e-2 / 5e-3.
"""

import os

import numpy as np
import pytest
from scipy.io import savemat

from coponerf_tpu.data import fast_loader as j_fast_loader
from coponerf_tpu.data import realestate as j_re
from coponerf_tpu_torch.data import fast_loader
from coponerf_tpu_torch.data import realestate as t_re
from coponerf_tpu_torch.data.scene_dataset import bilinear_resize, square_crop

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def cache_file(tmp_path_factory):
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 255, (5, 64, 96, 3), np.uint8)
    ts = np.arange(5, dtype=np.int64) * 1000
    path = str(tmp_path_factory.mktemp("cache") / "scene.cache")
    fast_loader.write_cache(path, ts, frames)
    return path, frames, ts


def test_library_builds_under_the_port(cache_file):
    lib = fast_loader.library_path()
    assert os.path.dirname(lib) == fast_loader.BUILD_DIR
    assert os.path.basename(os.path.dirname(lib)) == "_build" and os.path.exists(lib)
    runtime = os.path.dirname(fast_loader.SOURCE)
    assert os.path.commonpath([lib, runtime]) != runtime


def test_roundtrip(cache_file):
    path, frames, ts = cache_file
    c = fast_loader.SceneCache(path)
    assert c.n_frames == 5
    assert (c.height, c.width) == (64, 96)
    np.testing.assert_array_equal(c.timestamps, ts)
    np.testing.assert_array_equal(c.frame(3), frames[3])
    with pytest.raises(IndexError):
        c.frame(99)


def test_truncated_cache_rejected(cache_file, tmp_path):
    """A short or lying file fails at open, not in the frame accessors."""
    path, _, _ = cache_file
    blob = open(path, "rb").read()
    for cut in (4, 30, len(blob) // 2, len(blob) - 1):
        bad = tmp_path / f"trunc_{cut}.cache"
        bad.write_bytes(blob[:cut])
        with pytest.raises(IOError):
            fast_loader.SceneCache(str(bad))
    import struct

    hacked = bytearray(blob)
    hacked[8:16] = struct.pack("<Q", 10 ** 6)
    bad = tmp_path / "hacked_n.cache"
    bad.write_bytes(bytes(hacked))
    with pytest.raises(IOError):
        fast_loader.SceneCache(str(bad))


@pytest.mark.parametrize("size", [32, 48, 100])
def test_processed_matches_cv2_pipeline(cache_file, size):
    path, frames, _ = cache_file
    got = fast_loader.SceneCache(path).processed(2, out_size=size)
    ref = cv2.resize(square_crop(frames[2]), (size, size), interpolation=cv2.INTER_LINEAR)
    ref = ref.astype(np.float32) / 127.5 - 1
    np.testing.assert_allclose(got, ref, atol=2e-2)
    assert np.abs(got - ref).mean() < 5e-3
    # the numpy resize on floats is the same bilinear sampling, unrounded
    want = bilinear_resize(square_crop(frames[2]).astype(np.float32), (size, size)) / 127.5 - 1
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("hw,wh", [((360, 640), (455, 256)), ((64, 96), (32, 32)), ((32, 32), (77, 50)),
                                   ((256, 256), (64, 64))])
def test_bilinear_resize_matches_cv2(hw, wh):
    """The readers' resize without cv2 against cv2.INTER_LINEAR on uint8
    frames, on the [-1, 1] scale the readers use."""
    img = np.random.RandomState(sum(hw)).randint(0, 255, (*hw, 3), np.uint8)
    got = bilinear_resize(img, wh)
    assert got.dtype == np.uint8 and got.shape == (wh[1], wh[0], 3)
    ref = cv2.resize(img, wh).astype(np.float32) / 127.5 - 1
    got = got.astype(np.float32) / 127.5 - 1
    np.testing.assert_allclose(got, ref, atol=2e-2)
    assert np.abs(got - ref).mean() < 5e-3


def test_convert_scene_npz(tmp_path):
    """360-row frames are resized to the readers' base size by the numpy
    resize; the frames come back in timestamp order."""
    rng = np.random.RandomState(2)
    frames = {f"{ts}.png": rng.randint(0, 255, (360, 640, 3), np.uint8) for ts in (2000, 0, 1000)}
    np.savez(tmp_path / "data.npz", **frames)
    n = fast_loader.convert_scene_npz(str(tmp_path / "data.npz"), str(tmp_path / "scene.cache"))
    c = fast_loader.SceneCache(str(tmp_path / "scene.cache"))
    assert n == c.n_frames == 3 and (c.height, c.width) == (256, 455)
    np.testing.assert_array_equal(c.timestamps, [0, 1000, 2000])
    for i, ts in enumerate((0, 1000, 2000)):
        np.testing.assert_array_equal(c.frame(i), bilinear_resize(frames[f"{ts}.png"], (455, 256)))


@pytest.fixture(scope="module")
def cached_archive(tmp_path_factory):
    """Two scenes of 110 frames at 256 x 455 (train sampling keeps the
    contexts 50 frames apart), each with its data.npz and its
    scene.cache, and their pose table."""
    root = tmp_path_factory.mktemp("cached")
    img_root = root / "train"
    rng = np.random.RandomState(1)
    tables = {}
    for s in range(2):
        sdir = img_root / f"scene{s:03d}"
        sdir.mkdir(parents=True)
        frames = rng.randint(0, 255, (110, 256, 455, 3), np.uint8)
        ts = np.arange(110, dtype=np.int64) * 1000
        np.savez(sdir / "data.npz", **{f"{t}.png": f for t, f in zip(ts, frames)})
        fast_loader.write_cache(str(sdir / "scene.cache"), ts, frames)
        rows = []
        for i, t in enumerate(ts):
            w2c = np.eye(4)
            w2c[0, 3] = 0.01 * i
            rows.append([t, 0.9, 0.9, 0.5, 0.5, 0, 0, *w2c[:3].reshape(-1)])
        tables[f"scene{s:03d}"] = np.array(rows, np.float64)
    savemat(root / "train.mat", tables)
    return str(img_root), str(root / "train.mat")


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=path)


@pytest.mark.parametrize("kind", ["vis", "train"])
def test_cached_readers_match_jax(cached_archive, monkeypatch, kind):
    """Through the cache, the port's readers give the JAX package's items
    on the same cache (both read through the port's build of the library),
    eval triplets and train samples from the same seeds."""
    monkeypatch.setattr(j_fast_loader, "get_lib", fast_loader.get_lib)
    img_root, pose_root = cached_archive
    if kind == "vis":
        jd, td = j_re.RealEstate10kVis(img_root, pose_root), t_re.RealEstate10kVis(img_root, pose_root)
    else:
        jd = j_re.RealEstate10k(img_root, pose_root, query_sparsity=48, seed=3)
        td = t_re.RealEstate10k(img_root, pose_root, query_sparsity=48, seed=3)
    for i in (0, 1):
        np.random.seed(10 + i)
        ref = jd[i]
        np.random.seed(10 + i)
        _assert_same(td[i], ref)
    assert len(td._cache_handles) == len(jd._cache_handles) == 2
