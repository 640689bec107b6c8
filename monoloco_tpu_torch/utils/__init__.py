from .precision import serve_storage, serving_precision, tf32_matmuls
from .misc import (
    append_cluster,
    get_task_error,
    get_pixel_error,
    make_new_directory,
    normalize_hwl,
    average,
)
from .kitti import (
    get_calibration,
    get_translation,
    get_simplified_calibration,
    check_conditions,
    get_difficulty,
    split_training,
    factory_basename,
    read_and_rewrite,
    find_cluster,
    strip_to_devkit_columns,
)
from .logs import set_logger
from .nuscenes import select_categories
