"""Procedural synthetic stereo scenes with exact ground truth (numpy only).

The port's copy of ``coponerf_tpu/data/synthetic.py:make_batch``: a
textured plane seen by three pinhole cameras (2 context + 1 query) with
known relative pose.  The same seed gives the same arrays as the JAX
package's (``tests/test_torch_config_data.py``).  Batches use the dict
schema
  {'context': {rgb (B,2,H,W,3), cam2world, intrinsics},
   'query':   {rgb (B,1,N,3), cam2world, intrinsics, uv (B,1,N,2)}}, gt=query
and move to a device with ``models.batch_to_torch``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _texture(rng: np.random.RandomState, n_waves: int = 8):
    freqs = rng.randn(n_waves, 2) * 2.0
    phases = rng.rand(n_waves) * 2 * np.pi
    weights = rng.rand(n_waves, 3) / n_waves * 2

    def tex(x, y):
        # x, y: (...,) world-plane coords -> rgb in [-1, 1]
        arg = x[..., None] * freqs[:, 0] + y[..., None] * freqs[:, 1] + phases
        vals = np.sin(arg)[..., None] * weights  # (..., n_waves, 3)
        return np.clip(vals.sum(-2), -1, 1).astype(np.float32)

    return tex


def _rot_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _camera(tx: float, ty: float, yaw: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = _rot_y(yaw)
    m[0, 3], m[1, 3] = tx, ty
    return m


def _render(uv: np.ndarray, c2w: np.ndarray, K: np.ndarray, tex, plane_z: float) -> np.ndarray:
    """Ray-cast pixels uv (N, 2) from camera c2w into the plane z=plane_z."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    d_cam = np.stack(
        [(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy, np.ones(len(uv), np.float32)], axis=-1
    )
    d_world = d_cam @ c2w[:3, :3].T
    o = c2w[:3, 3]
    t = (plane_z - o[2]) / d_world[:, 2]
    pts = o[None] + t[:, None] * d_world
    return tex(pts[:, 0], pts[:, 1])


def make_batch(
    batch_size: int = 1,
    image_size: int = 64,
    n_rays: int = 128,
    seed: int = 0,
    baseline: float = 0.3,
    plane_z: float = 3.0,
    full_query_image: bool = False,
) -> Tuple[Dict, Dict]:
    rng = np.random.RandomState(seed)
    H = W = image_size
    f = image_size * 0.9
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = f
    K[0, 2] = K[1, 2] = image_size / 2.0

    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).reshape(-1, 2).astype(np.float32)

    ctx_rgb = np.zeros((batch_size, 2, H, W, 3), np.float32)
    ctx_c2w = np.zeros((batch_size, 2, 4, 4), np.float32)
    q_rgb, q_uv, q_c2w = [], [], []
    for b in range(batch_size):
        tex = _texture(np.random.RandomState(seed * 131 + b))
        cam1 = _camera(0.0, 0.0, 0.0)
        cam2 = _camera(baseline, 0.02 * rng.randn(), 0.05 * rng.randn())
        camq = _camera(baseline / 2, 0.0, 0.0)
        ctx_rgb[b, 0] = _render(grid, cam1, K, tex, plane_z).reshape(H, W, 3)
        ctx_rgb[b, 1] = _render(grid, cam2, K, tex, plane_z).reshape(H, W, 3)
        ctx_c2w[b, 0], ctx_c2w[b, 1] = cam1, cam2
        if full_query_image:
            uv = grid
        else:
            idx = rng.permutation(H * W)[:n_rays]
            uv = grid[idx]
        q_rgb.append(_render(uv, camq, K, tex, plane_z))
        q_uv.append(uv)
        q_c2w.append(camq)

    query = {
        "rgb": np.stack(q_rgb)[:, None],
        "uv": np.stack(q_uv)[:, None],
        "cam2world": np.stack(q_c2w)[:, None],
        "intrinsics": np.tile(K, (batch_size, 1, 1, 1)),
    }
    context = {
        "rgb": ctx_rgb,
        "cam2world": ctx_c2w,
        "intrinsics": np.tile(K, (batch_size, 2, 1, 1)),
    }
    return {"context": context, "query": query}, query
