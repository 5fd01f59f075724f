"""Plucker-line utilities: ray embedding and closest-point intersection.

Counterpart of ``coponerf_tpu/geometry/plucker.py`` (f32, same NaN scrub).
"""

from __future__ import annotations

import torch

from portbench.reference.geometry import cameras


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def plucker_embedding(cam2world: torch.Tensor, uv: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """(direction, moment) of pixel rays: cam2world (B, 4, 4), uv (B, N, 2)
    pixels, intrinsics (B, 4, 4) -> (B, N, 6)."""
    ray_dirs = cameras.get_ray_directions(uv, cam2world=cam2world, intrinsics=intrinsics)
    cam_pos = cameras.get_ray_origin(cam2world)
    cam_pos = cam_pos[..., None, :].expand(ray_dirs.shape)
    moment = _cross(cam_pos, ray_dirs)
    return torch.cat((ray_dirs, moment), dim=-1)


def plucker_line_intersection(line_1: torch.Tensor, line_2: torch.Tensor):
    """Closest points (p1 on line_1, p2 on line_2) between Plucker lines."""
    line_1 = line_1.expand(line_2.shape)
    l1, m1 = line_1[..., :3], line_1[..., 3:]
    l2, m2 = line_2[..., :3], line_2[..., 3:]

    l1_cross_l2 = _cross(l1, l2)
    cross_sq = torch.sum(l1_cross_l2 * l1_cross_l2, dim=-1, keepdim=True) + 1e-12

    l2_cross_l1_cross_l2 = _cross(l2, l1_cross_l2)
    term_a = -_cross(m1, l2_cross_l1_cross_l2)
    term_b = torch.sum(m2 * l1_cross_l2, dim=-1, keepdim=True) * l1
    p1 = (term_a + term_b) / cross_sq

    l1_cross_l1_cross_l2 = _cross(l1, l1_cross_l2)
    term_c = _cross(m2, l1_cross_l1_cross_l2)
    term_d = torch.sum(m1 * l1_cross_l2, dim=-1, keepdim=True) * l2
    p2 = (term_c - term_d) / cross_sq
    return p1, p2


def get_3d_point_epipolar(query_ray, pixel_val, context_cam2world, H: int, W: int, intrinsics):
    """3D point on the query ray nearest to each epipolar-sample pixel ray.

    query_ray: (B, N, 6); pixel_val: (B, N, S, 2) in [-1, 1];
    context_cam2world, intrinsics: (B, 4, 4).
    Returns (p1 (B,N,S,3), dist (B,N,S,1), parallel (B,N,S), equivalent (B,N,S)).
    """
    b, n_qry = query_ray.shape[:2]
    n_pts = pixel_val.shape[-2]
    pixel_x = (pixel_val[..., 0:1] + 1) / 2 * (W - 1)
    pixel_y = (pixel_val[..., 1:2] + 1) / 2 * (H - 1)
    pixel_coord = torch.cat((pixel_x, pixel_y), dim=-1).reshape(b, n_qry * n_pts, 2)

    context_plucker = plucker_embedding(context_cam2world, pixel_coord, intrinsics)
    context_plucker = context_plucker.reshape(b, n_qry, n_pts, 6)

    line_1 = query_ray[..., None, :]
    p1, p2 = plucker_line_intersection(line_1, context_plucker)

    line_1b = line_1.expand(context_plucker.shape)
    l1 = line_1b[..., :3]
    l2 = context_plucker[..., :3]
    parallel = torch.linalg.vector_norm(_cross(l1, l2), dim=-1) < 1e-12

    u1 = cameras.normalize(line_1b)
    u2 = cameras.normalize(context_plucker)
    equivalent = torch.abs(1.0 - torch.sum(u1 * u2, dim=-1)) < 1e-12

    dist = torch.linalg.vector_norm(p2 - p1, dim=-1)[..., None]
    p1 = torch.nan_to_num(p1, nan=0.0, posinf=0.0, neginf=0.0)
    return p1, dist, parallel, equivalent
