"""Novel-view trajectory rendering: one ``encode`` of a stereo pair, then a
whole image rendered at each pose of a camera path (the interactive serving
path).

The port of ``coponerf_tpu/eval/trajectory.py:39-135`` (reference
analogue: data/realestate10k_dataio.py:80-172 get_camera_pose and
test.py:102-108 make_circle).  Each frame is the evaluation harness's
chunked render (``eval/harness.py:make_renderer``) with the query's
``cam2world`` replaced by the path's pose, so under the fast config a frame
launches K8a, K2 and K3 as an evaluation image does (K8a and K6 where the
model carries ``fusion="render_core"``).  The JAX package maps
the frames inside one jitted dispatch (``make_path_renderer``); here they
are a plain loop.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from coponerf_tpu_torch.eval.harness import make_renderer
from coponerf_tpu_torch.models.coponerf import batch_to_torch


def make_circle(n: int, radius: float = 0.1) -> np.ndarray:
    """Circular offsets in the camera plane (test.py:102-108)."""
    angles = np.linspace(0, 4 * np.pi, n)
    return np.stack([np.cos(angles) * radius, np.sin(angles) * radius, np.zeros(n)], axis=-1)


def interpolate_poses(pose_a: np.ndarray, pose_b: np.ndarray, n: int) -> np.ndarray:
    """``n`` poses from ``pose_a`` to ``pose_b``: translations blended
    linearly, rotations blended and projected back onto SO(3) by SVD
    (adequate for RealEstate10K's small inter-context rotations)."""
    out = []
    for t in np.linspace(0.0, 1.0, n):
        m = np.eye(4, dtype=np.float32)
        u, _, vt = np.linalg.svd((1 - t) * pose_a[:3, :3] + t * pose_b[:3, :3])
        m[:3, :3] = u @ vt
        m[:3, 3] = (1 - t) * pose_a[:3, 3] + t * pose_b[:3, 3]
        out.append(m)
    return np.stack(out)


def full_image_uv(dim: int) -> np.ndarray:
    """Pixel coordinates (x, y) of every pixel of a dim x dim image, row-major."""
    return np.stack(np.meshgrid(np.arange(dim), np.arange(dim)), -1).reshape(-1, 2).astype(np.float32)


def render_poses(model, batch: Dict, state, poses, chunk: int = 4096) -> torch.Tensor:
    """Render ``batch``'s full query image at every pose of ``poses``
    ((n, 4, 4)) from one ``state``: (n, n_rays, 3) on the model's device."""
    _, render_image = make_renderer(model, chunk, keys=("rgb",))
    n_rays = batch["query"]["uv"].shape[2]
    poses = torch.as_tensor(np.asarray(poses), dtype=torch.float32, device=batch["query"]["uv"].device)
    frames = []
    for pose in poses:
        q = dict(batch["query"], cam2world=pose[None, None])
        frames.append(render_image({"context": batch["context"], "query": q}, state, n_rays)["rgb"][0, 0])
    return torch.stack(frames)


def _path_batch(context: Dict, intrinsics, pose0: np.ndarray, dim: int, device) -> Dict:
    """A B=1 batch whose query is the full dim x dim image at ``pose0``
    (arrays or tensors in, f32 tensors on ``device`` out)."""
    n_rays = dim * dim
    return batch_to_torch({"context": context, "query": {
        "uv": full_image_uv(dim)[None, None], "rgb": np.zeros((1, 1, n_rays, 3), np.float32),
        "cam2world": np.asarray(pose0)[None, None], "intrinsics": intrinsics.reshape(1, 1, 4, 4)}},
        device)


def render_scene_path(model, path_item: Dict, image_size: int = 256, chunk: int = 4096,
                      max_frames: Optional[int] = None) -> np.ndarray:
    """Render every query pose of a ``CameraPathDataset`` item with one
    encode: (n_frames, H, W, 3) in [-1, 1].  The first frame's intrinsics
    serve the whole path (one camera per RealEstate10K scene)."""
    device = next(model.parameters()).device
    poses = path_item["query_path"]["cam2world"]
    intr = path_item["query_path"]["intrinsics"]
    if max_frames:
        poses, intr = poses[:max_frames], intr[:max_frames]
    ctx = {k: np.asarray(v)[None] for k, v in path_item["context"].items()}
    batch = _path_batch(ctx, intr[0], poses[0], image_size, device)
    encode, _ = make_renderer(model, chunk)
    rgb = render_poses(model, batch, encode(batch), poses, chunk)
    return rgb.float().cpu().numpy().reshape(len(poses), image_size, image_size, 3)


def render_trajectory(model, batch: Dict, n_frames: int = 30, image_size: int = 256, chunk: int = 4096,
                      circle_radius: Optional[float] = None) -> np.ndarray:
    """Render ``n_frames`` views on the path between the two context
    cameras of a B=1 stereo-pair ``batch`` (numpy or tensors), optionally
    perturbed by a circle, with one encode: (n_frames, H, W, 3) in [-1, 1]."""
    device = next(model.parameters()).device
    batch = batch_to_torch(batch, device)
    encode, _ = make_renderer(model, chunk)
    state = encode(batch)
    c2w = batch["context"]["cam2world"][0].cpu().numpy()
    path = interpolate_poses(c2w[0], c2w[1], n_frames)
    if circle_radius:
        path[:, :3, 3] += make_circle(n_frames, circle_radius)
    fb = _path_batch(batch["context"], batch["query"]["intrinsics"][0, 0], path[0], image_size, device)
    rgb = render_poses(model, fb, state, path, chunk)
    return rgb.float().cpu().numpy().reshape(n_frames, image_size, image_size, 3)
