"""The benchmark's traffic generator: procedural stereo scenes from a seed.

A copy of the port's ``data/synthetic.py:make_batch`` (itself the JAX
package's): a textured plane at z = 3 seen by three pinhole cameras, two
context cameras (the second shifted by a 0.3 baseline, with a small random
height and yaw) and one query camera halfway between them.  The random
draws are numpy's, one generator per pair from (seed, pair index); the
texture is evaluated with torch on the device the batch is made for, so a
pool of 256^2 pairs costs milliseconds.  Every seed gives the same sizes.

Batches use the port's dict schema, f32 tensors on the device:
  {'context': {rgb (B,2,H,W,3), cam2world (B,2,4,4), intrinsics (B,2,4,4)},
   'query':   {rgb (B,1,N,3), cam2world (B,1,4,4), intrinsics (B,1,4,4), uv (B,1,N,2)}}
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

N_WAVES = 8
PLANE_Z = 3.0
BASELINE = 0.3


def _rot_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _camera(tx: float, ty: float, yaw: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = _rot_y(yaw)
    m[0, 3], m[1, 3] = tx, ty
    return m


def intrinsics(image_size: int) -> np.ndarray:
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = image_size * 0.9
    K[0, 2] = K[1, 2] = image_size / 2.0
    return K


def full_image_uv(dim: int) -> np.ndarray:
    """Pixel coordinates (x, y) of every pixel of a dim x dim image, row-major."""
    return np.stack(np.meshgrid(np.arange(dim), np.arange(dim)), -1).reshape(-1, 2).astype(np.float32)


def _render(uv: torch.Tensor, c2w: np.ndarray, K: np.ndarray, tex: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Ray-cast pixels uv (N, 2) from camera c2w into the plane z = PLANE_Z."""
    fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))
    d_cam = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy, torch.ones_like(uv[:, 0])], dim=-1)
    R = torch.as_tensor(c2w[:3, :3], device=uv.device)
    o = torch.as_tensor(c2w[:3, 3], device=uv.device)
    d_world = d_cam @ R.T
    t = (PLANE_Z - o[2]) / d_world[:, 2]
    pts = o[None] + t[:, None] * d_world
    arg = pts[:, 0:1] * tex["freqs"][:, 0] + pts[:, 1:2] * tex["freqs"][:, 1] + tex["phases"]
    vals = torch.sin(arg)[..., None] * tex["weights"]          # (N, n_waves, 3)
    return torch.clamp(vals.sum(-2), -1, 1)


def pair(seed: int, index: int) -> Dict[str, np.ndarray]:
    """The random draws of one pair: its texture and its cameras."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), index])
    freqs = rng.standard_normal((N_WAVES, 2)) * 2.0
    phases = rng.random(N_WAVES) * 2 * np.pi
    weights = rng.random((N_WAVES, 3)) / N_WAVES * 2
    cam2 = _camera(BASELINE, 0.02 * rng.standard_normal(), 0.05 * rng.standard_normal())
    return {"freqs": freqs, "phases": phases, "weights": weights,
            "cams": np.stack([_camera(0.0, 0.0, 0.0), cam2]), "query_cam": _camera(BASELINE / 2, 0.0, 0.0),
            "rng": rng}


def make_batch(seed: int, indices: List[int], image_size: int, n_rays: int, device,
               full_query_image: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """A batch of the pairs ``indices`` of ``seed``: the query is the whole
    image (``full_query_image``) or ``n_rays`` random pixels of it."""
    H = W = image_size
    K = intrinsics(image_size)
    grid = torch.as_tensor(full_image_uv(image_size), device=device)
    ctx_rgb, ctx_c2w, q_rgb, q_uv, q_c2w = [], [], [], [], []
    for i in indices:
        p = pair(seed, i)
        tex = {k: torch.as_tensor(np.asarray(p[k], np.float32), device=device) for k in ("freqs", "phases", "weights")}
        ctx_rgb.append(torch.stack([_render(grid, c, K, tex).reshape(H, W, 3) for c in p["cams"]]))
        ctx_c2w.append(p["cams"])
        uv = grid if full_query_image else grid[torch.as_tensor(p["rng"].permutation(H * W)[:n_rays], device=device)]
        q_rgb.append(_render(uv, p["query_cam"], K, tex))
        q_uv.append(uv)
        q_c2w.append(p["query_cam"])
    B = len(indices)
    f32 = dict(dtype=torch.float32, device=device)
    Kt = torch.as_tensor(K, **f32)
    return {
        "context": {"rgb": torch.stack(ctx_rgb), "cam2world": torch.as_tensor(np.stack(ctx_c2w), **f32),
                    "intrinsics": Kt.expand(B, 2, 4, 4).contiguous()},
        "query": {"rgb": torch.stack(q_rgb)[:, None], "uv": torch.stack(q_uv)[:, None],
                  "cam2world": torch.as_tensor(np.stack(q_c2w), **f32)[:, None],
                  "intrinsics": Kt.expand(B, 1, 4, 4).contiguous()},
    }


def interpolate_poses(pose_a: np.ndarray, pose_b: np.ndarray, n: int) -> np.ndarray:
    """``n`` poses from ``pose_a`` to ``pose_b``: translations blended
    linearly, rotations blended and projected back onto SO(3) by SVD (a copy
    of the port's ``eval/trajectory.py:interpolate_poses``)."""
    out = []
    for t in np.linspace(0.0, 1.0, n):
        m = np.eye(4, dtype=np.float32)
        u, _, vt = np.linalg.svd((1 - t) * pose_a[:3, :3] + t * pose_b[:3, :3])
        m[:3, :3] = u @ vt
        m[:3, 3] = (1 - t) * pose_a[:3, 3] + t * pose_b[:3, 3]
        out.append(m)
    return np.stack(out)


def path_batch(batch: Dict[str, Dict[str, torch.Tensor]], pose: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
    """A B=1 pair ``batch`` whose query camera is ``pose`` (4, 4): one frame
    of a camera path, as the port's ``render_poses`` builds it."""
    return {"context": batch["context"], "query": dict(batch["query"], cam2world=pose[None, None])}
