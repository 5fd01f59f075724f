from portbench.reference.geometry.cameras import (
    batch_project_to_other_img,
    encode_relative_point,
    from_homogeneous,
    get_ray_directions,
    get_ray_directions_cam,
    geodesic_rotation_distance,
    get_ray_origin,
    lift,
    parse_intrinsics,
    pose_inverse_4x4,
    project,
    project_cam2world,
    r6d2mat,
    to_homogeneous,
    world_from_xy_depth,
)
from portbench.reference.geometry.epipolar import project_rays
from portbench.reference.geometry.plucker import (
    get_3d_point_epipolar,
    plucker_embedding,
    plucker_line_intersection,
)
