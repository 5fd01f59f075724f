"""Epipolar segments: project query rays into a context camera and clip the
projected ray to the image frame.

Counterpart of ``coponerf_tpu/geometry/epipolar.py``.  Coordinates are in the
0-1 normalized image plane (intrinsics pre-normalized by image size).
"""

from __future__ import annotations

import torch

from coponerf_tpu_torch import trace
from coponerf_tpu_torch.geometry.cameras import to_homogeneous


def _project_normalized(points: torch.Tensor, intrinsics: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """K @ (p / z) -> xy, for (camera, ray, 3) points and (camera, 3, 3) K."""
    points = points / (points[..., -1:] + epsilon)
    points = torch.einsum("cij,crj->cri", intrinsics, points)
    return points[..., :2]


def _is_in_bounds(xy: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    return torch.all(xy >= -epsilon, dim=-1) & torch.all(xy <= 1 + epsilon, dim=-1)


def _is_in_front(xyz: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    return xyz[..., -1] > -epsilon


def _intersect_image_coordinate(intrinsics, origins, directions, dim: int, coordinate_value: float):
    """Intersection of a ray's image-plane projection with the border line
    {x = v} (dim=0) or {y = v} (dim=1); infinite t from parallel rays is left
    unguarded, as in the reference."""
    other = 1 - dim
    K = intrinsics[:, None]
    fs = K[..., dim, dim]
    fo = K[..., other, other]
    cs = K[..., dim, 2]
    co = K[..., other, 2]
    os_ = origins[..., dim]
    oo = origins[..., other]
    ds = directions[..., dim]
    do = directions[..., other]
    oz = origins[..., 2]
    dz = directions[..., 2]
    c = (coordinate_value - cs) / fs

    t = (c * oz - os_) / (ds - c * dz)

    coord_num = fo * (oo * (c * dz - ds) + do * (os_ - c * oz))
    coord_den = dz * os_ - ds * oz
    coord_other = co + coord_num / coord_den
    coord_same = torch.full_like(coord_other, coordinate_value)
    if dim == 0:
        xy = torch.stack([coord_same, coord_other], dim=-1)
    else:
        xy = torch.stack([coord_other, coord_same], dim=-1)
    xyz = origins + t[..., None] * directions
    valid = _is_in_bounds(xy) & _is_in_front(xyz)
    return {"t": t, "xy": xy, "valid": valid}


def _compare_projections(intersections, reduction: str):
    t = torch.stack([i["t"] for i in intersections], dim=0)
    xy = torch.stack([i["xy"] for i in intersections], dim=0)
    valid = torch.stack([i["valid"] for i in intersections], dim=0)

    lowest = float("inf") if reduction == "min" else float("-inf")
    t = torch.where(valid, t, torch.full_like(t, lowest))
    # infinities go to the largest finite values, as jnp.nan_to_num does
    t = torch.nan_to_num(t, nan=lowest)

    # first index of the extremum, as jnp.argmin/argmax (ties -> lowest index)
    sel = torch.argmin(t, dim=0) if reduction == "min" else torch.argmax(t, dim=0)
    sel_e = sel[None]
    t_red = torch.gather(t, 0, sel_e)[0]
    xy_red = torch.gather(xy, 0, sel_e[..., None].expand(1, *xy.shape[1:]))[0]
    valid_red = torch.gather(valid, 0, sel_e)[0]
    return {"t": t_red, "xy": xy_red, "valid": valid_red}


def _point_projection(xyz, t, intrinsics):
    xy = _project_normalized(xyz, intrinsics)
    return {"t": t, "xy": xy, "valid": _is_in_bounds(xy) & _is_in_front(xyz)}


def project_rays(origins, directions, extrinsics, intrinsics, epsilon: float = 1e-6):
    """Clip each world-space ray's projection to the image of each camera.

    origins/directions: (camera, ray, 3); extrinsics: (camera, 4, 4)
    cam2world; intrinsics: (camera, 3or4, 3or4) normalized to a 0-1 image.
    Returns t_min/t_max (camera, ray), xy_min/xy_max (camera, ray, 2) and
    overlaps_image (camera, ray) bool.
    """
    intrinsics = intrinsics[..., :3, :3]

    world_to_cam = torch.linalg.inv(extrinsics)
    trace.count("host_syncs")        # linalg.inv checks its result on the host
    o = torch.einsum("cij,crj->cri", world_to_cam, to_homogeneous(origins))[..., :3]
    d_h = torch.cat([directions, torch.zeros_like(directions[..., :1])], dim=-1)
    d = torch.einsum("cij,crj->cri", world_to_cam, d_h)[..., :3]

    frame = (
        _intersect_image_coordinate(intrinsics, o, d, 0, 0.0),
        _intersect_image_coordinate(intrinsics, o, d, 0, 1.0),
        _intersect_image_coordinate(intrinsics, o, d, 1, 0.0),
        _intersect_image_coordinate(intrinsics, o, d, 1, 1.0),
    )
    frame_min = _compare_projections(frame, "min")
    frame_max = _compare_projections(frame, "max")

    # projection at zero depth: if the origin sits at the camera, project the
    # direction instead; if it merely lies on the z=0 plane, mark invalid
    mask_depth_zero = o[..., -1] < epsilon
    mask_at_camera = torch.linalg.vector_norm(o, dim=-1) < epsilon
    origins_for_projection = torch.where(mask_at_camera[..., None], d, o)
    projection_at_zero = _point_projection(
        origins_for_projection, torch.zeros_like(frame_min["t"]), intrinsics
    )
    zero_valid = projection_at_zero["valid"] & ~(mask_depth_zero & ~mask_at_camera)

    # projection at infinite depth == projecting the direction vector
    projection_at_infinity = _point_projection(
        d, torch.full_like(frame_min["t"], float("inf")), intrinsics
    )
    inf_valid = projection_at_infinity["valid"]

    t_min = torch.where(zero_valid, projection_at_zero["t"], frame_min["t"])
    xy_min = torch.where(zero_valid[..., None], projection_at_zero["xy"], frame_min["xy"])
    v_min = torch.where(zero_valid, zero_valid, frame_min["valid"])

    t_max = torch.where(inf_valid, projection_at_infinity["t"], frame_max["t"])
    xy_max = torch.where(inf_valid[..., None], projection_at_infinity["xy"], frame_max["xy"])
    v_max = torch.where(inf_valid, inf_valid, frame_max["valid"])

    return {
        "t_min": t_min,
        "t_max": t_max,
        "xy_min": xy_min,
        "xy_max": xy_max,
        "overlaps_image": v_min & v_max,
    }
