from .camera import (
    pixel_to_camera,
    get_keypoints,
    back_correct_angles,
    to_cartesian,
)
from .iou import (
    iou_matrix,
    get_iou_matrix,
    calculate_iou,
    get_iou_matches,
    get_iou_matches_matrix,
    reorder_matches,
    get_category,
    open_annotations,
)
from .host import (
    np_get_keypoints,
    np_pixel_to_camera,
    np_xyz_from_distance,
    correct_angle,
    to_spherical,
    project_3d,
)
from .stereo import (
    BF,
    average_locations,
    depth_to_pixel_error,
    disparity_to_depth,
    extract_stereo_matches,
    interquartile_mask,
    mask_joint_disparity,
    verify_stereo,
)
