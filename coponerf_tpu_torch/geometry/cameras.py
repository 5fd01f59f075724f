"""Camera / pose primitives on torch tensors (f32, batched).

Counterpart of ``coponerf_tpu/geometry/cameras.py``: same formulas, same
operation order, same non-finite scrubbing, so each function matches the
JAX one to f32 round-off.
"""

from __future__ import annotations

import torch

from coponerf_tpu_torch import trace

PROJ_SENTINEL = 1.0e10  # non-finite projections are scrubbed to this value


def to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def from_homogeneous(points: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return points[..., :-1] / (points[..., -1:] + eps)


def get_ray_origin(cam2world: torch.Tensor) -> torch.Tensor:
    return cam2world[..., :3, 3]


def parse_intrinsics(intrinsics: torch.Tensor):
    """Returns fx, fy, cx, cy each with a trailing singleton dim."""
    fx = intrinsics[..., 0, :1]
    fy = intrinsics[..., 1, 1:2]
    cx = intrinsics[..., 0, 2:3]
    cy = intrinsics[..., 1, 2:3]
    return fx, fy, cx, cy


def _expand_as(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    while x.dim() < y.dim():
        x = x[..., None]
    return x


def lift(x, y, z, intrinsics, homogeneous: bool = False) -> torch.Tensor:
    """Unproject pixel coords (x, y) at depth z into camera space."""
    fx, fy, cx, cy = parse_intrinsics(intrinsics)
    x_lift = (x - _expand_as(cx, x)) / _expand_as(fx, x) * z
    y_lift = (y - _expand_as(cy, y)) / _expand_as(fy, y) * z
    if homogeneous:
        return torch.stack((x_lift, y_lift, z, torch.ones_like(z)), dim=-1)
    return torch.stack((x_lift, y_lift, z), dim=-1)


def project(x, y, z, intrinsics) -> torch.Tensor:
    """Project camera-space points to pixels; non-finite results become the
    1e10 sentinel."""
    fx, fy, cx, cy = parse_intrinsics(intrinsics)
    x_proj = _expand_as(fx, x) * x / (z + 1e-12) + _expand_as(cx, x)
    y_proj = _expand_as(fy, y) * y / (z + 1e-12) + _expand_as(cy, y)
    coord = torch.stack((x_proj, y_proj, z), dim=-1)
    return torch.nan_to_num(
        coord, nan=PROJ_SENTINEL, posinf=PROJ_SENTINEL, neginf=PROJ_SENTINEL
    )


def _affine3(T: torch.Tensor, x, y, z) -> torch.Tensor:
    """Rows 0:3 of T @ [x, y, z, 1], T (..., 4, 4) aligned to the point dims."""
    return (
        T[..., :3, 0] * x[..., None]
        + T[..., :3, 1] * y[..., None]
        + T[..., :3, 2] * z[..., None]
        + T[..., :3, 3]
    )


def project_cam2world(world_coords: torch.Tensor, cam2world: torch.Tensor) -> torch.Tensor:
    """World points (B, N, 3) into the camera frame of ``cam2world`` (B, 4, 4)."""
    w2c = torch.linalg.inv(cam2world)
    trace.count("host_syncs")        # linalg.inv checks its result on the host
    return _affine3(
        w2c[..., None, :, :],
        world_coords[..., 0], world_coords[..., 1], world_coords[..., 2],
    )


def world_from_xy_depth(xy, depth, cam2world, intrinsics) -> torch.Tensor:
    fx, fy, cx, cy = parse_intrinsics(intrinsics)
    x = xy[..., 0]
    y = xy[..., 1]
    x_lift = (x - _expand_as(cx, x)) / _expand_as(fx, x) * depth
    y_lift = (y - _expand_as(cy, y)) / _expand_as(fy, y) * depth
    return _affine3(cam2world[..., None, :, :], x_lift, y_lift, depth)


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Divide by max(norm, eps), as torch.nn.functional.normalize does."""
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    return v / torch.clamp(n, min=eps)


def get_ray_directions(xy, cam2world, intrinsics) -> torch.Tensor:
    """World-space unit ray directions through pixels ``xy``."""
    z_cam = torch.ones(xy.shape[:-1], dtype=xy.dtype, device=xy.device)
    pixel_points = world_from_xy_depth(xy, z_cam, cam2world, intrinsics)
    cam_pos = cam2world[..., :3, 3]
    return normalize(pixel_points - cam_pos[..., None, :])


def get_ray_directions_cam(uv, intrinsics, H: int, W: int) -> torch.Tensor:
    """Camera-space unit ray directions for [-1, 1]-normalized uv."""
    y_cam = (uv[..., 1] + 1) / 2 * (H - 1)
    x_cam = (uv[..., 0] + 1) / 2 * (W - 1)
    z_cam = torch.ones_like(x_cam)
    return normalize(lift(x_cam, y_cam, z_cam, intrinsics, homogeneous=False))


def pose_inverse_4x4(mat: torch.Tensor) -> torch.Tensor:
    """Invert an SE(3) matrix without a linear solve: R^T, -R^T t."""
    R = mat[..., :3, :3]
    t = mat[..., :3, 3:]
    R_inv = R.transpose(-1, -2)
    t_inv = -R_inv @ t
    top = torch.cat([R_inv, t_inv], dim=-1)
    bottom = torch.zeros_like(mat[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def encode_relative_point(points: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Per-(batch, view) SE(3) transforms of sampled points.

    points: (B*V, N, S, 3); transform: (B, V, 4, 4) -> (B*V, N, S, 3).
    """
    s = points.shape
    b, v = transform.shape[:2]
    pts = points.reshape(b, v, *s[1:])
    T = transform[:, :, None, None]
    out = _affine3(T, pts[..., 0], pts[..., 1], pts[..., 2])
    return out.reshape(*s)


def r6d2mat(d6: torch.Tensor) -> torch.Tensor:
    """6D rotation (Zhou et al. 2019) -> rotation matrix by Gram-Schmidt;
    rows are the orthonormal basis."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = normalize(a1)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = normalize(b2)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-2)


def batch_project_to_other_img(kpi, di, Ki, Kj, T_itoj):
    """Project pixels of image i (depths di) into image j.

    kpi: (B, N, 2); di: (B, N) or (B, N, 1); Ki/Kj: (B, 3, 3);
    T_itoj: (B, 4, 4) -> (B, N, 2) pixels in image j.
    """
    if di.dim() == kpi.dim():
        di = di[..., 0]
    kpi_3d_i = to_homogeneous(kpi) @ torch.linalg.inv(Ki).transpose(-1, -2)
    trace.count("host_syncs")        # linalg.inv checks its result on the host
    kpi_3d_i = kpi_3d_i * di[..., None]
    kpi_3d_j = from_homogeneous(to_homogeneous(kpi_3d_i) @ T_itoj.transpose(-1, -2))
    return from_homogeneous(kpi_3d_j @ Kj.transpose(-1, -2))


def geodesic_rotation_distance(m1: torch.Tensor, m2: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Per-pair geodesic angle between rotation matrices (radians).  ``eps``
    > 0 clips the cosine away from +-1, so the arccos gradient stays finite
    when the rotations align (the pose loss uses 1e-7)."""
    m = m1 @ m2.transpose(-1, -2)
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0) / 2.0
    return torch.arccos(torch.clamp(cos, -1.0 + eps, 1.0 - eps))
