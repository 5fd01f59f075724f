"""ctypes binding of the native scene cache (``runtime/scenecache.cpp``).

The port's own copy of ``coponerf_tpu/data/fast_loader.py``.  The cache
turns a scene's ``data.npz`` once into a flat, mmap-able file; a sample's
work (square crop, bilinear resize, float conversion: the reference's
realestate10k_dataio.py:237-456 hot path) is then one native call writing
into a preallocated buffer.

The library is built at first use with ``g++ -O3 -shared -fPIC`` from
``runtime/scenecache.cpp`` into the git-ignored
``coponerf_tpu_torch/_build/``, under a file name that hashes the source
and the flags, so an edited source is never served by a stale build.
Nothing is written under ``runtime/``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "runtime", "scenecache.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None

_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "scenecache_open": (ctypes.c_void_p, [ctypes.c_char_p]),
    "scenecache_close": (None, [ctypes.c_void_p]),
    "scenecache_num_frames": (ctypes.c_int64, [ctypes.c_void_p]),
    "scenecache_shape": (None, [ctypes.c_void_p, _I64P, _I64P]),
    "scenecache_timestamps": (None, [ctypes.c_void_p, _I64P]),
    "scenecache_get_frame": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]),
    "scenecache_load_processed": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                                 ctypes.POINTER(ctypes.c_float)]),
    "scenecache_write": (ctypes.c_int, [ctypes.c_char_p, _I64P, ctypes.POINTER(ctypes.c_uint8),
                                        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]),
}


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libscenecache_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if none exists for the current source."""
    out = library_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "scenecache.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(out):
                cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
                tmp = out + f".tmp{os.getpid()}"
                res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"{cxx} failed on {SOURCE} ({res.returncode}):\n{res.stderr}")
                os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class SceneCache:
    """Zero-copy reader over one scene's cache file."""

    def __init__(self, path: str):
        self._lib = get_lib()
        self._h = self._lib.scenecache_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open scene cache: {path}")
        hh, ww = ctypes.c_int64(), ctypes.c_int64()
        self._lib.scenecache_shape(self._h, ctypes.byref(hh), ctypes.byref(ww))
        self.height, self.width = hh.value, ww.value
        self.n_frames = self._lib.scenecache_num_frames(self._h)
        self.timestamps = np.empty(self.n_frames, np.int64)
        self._lib.scenecache_timestamps(self._h, _ptr(self.timestamps, ctypes.c_int64))

    def frame(self, i: int) -> np.ndarray:
        out = np.empty((self.height, self.width, 3), np.uint8)
        if self._lib.scenecache_get_frame(self._h, i, _ptr(out, ctypes.c_uint8)) != 0:
            raise IndexError(i)
        return out

    def processed(self, i: int, out_size: int = 256, out: Optional[np.ndarray] = None) -> np.ndarray:
        """Square crop, bilinear resize to ``out_size`` and [-1, 1] floats,
        fused in C++."""
        if out is None:
            out = np.empty((out_size, out_size, 3), np.float32)
        if self._lib.scenecache_load_processed(self._h, i, out_size, _ptr(out, ctypes.c_float)) != 0:
            raise IndexError(i)
        return out

    def close(self) -> None:
        if self._h:
            self._lib.scenecache_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_cache(path: str, timestamps: np.ndarray, frames: np.ndarray) -> None:
    """frames: (N, H, W, 3) uint8; timestamps: (N,) int64, sorted."""
    lib = get_lib()
    timestamps = np.ascontiguousarray(timestamps, np.int64)
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w, _ = frames.shape
    if lib.scenecache_write(path.encode(), _ptr(timestamps, ctypes.c_int64), _ptr(frames, ctypes.c_uint8),
                            n, h, w) != 0:
        raise IOError(f"cache write failed: {path}")


def convert_scene_npz(npz_path: str, cache_path: str, base_hw=(256, 455)) -> int:
    """One-time conversion data.npz -> scene.cache, frames resized to
    ``base_hw`` as the readers expect (realestate10k_dataio.py:341-342) by
    the readers' numpy ``bilinear_resize``; returns the frame count."""
    from coponerf_tpu_torch.data.scene_dataset import bilinear_resize

    data = np.load(npz_path)
    names = sorted(data.keys(), key=lambda s: int(s.split(".")[0]))
    ts = np.array([int(s.split(".")[0]) for s in names], np.int64)
    frames = []
    for nm in names:
        f = data[nm]
        if f.shape[:2] != tuple(base_hw):
            f = bilinear_resize(f, (base_hw[1], base_hw[0]))
        frames.append(f)
    write_cache(cache_path, ts, np.stack(frames))
    return len(frames)
