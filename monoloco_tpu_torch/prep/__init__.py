from .transforms import (
    COCO_KEYPOINTS,
    HFLIP_INDEX,
    transform_keypoints,
    flip_inputs,
    flip_labels,
    height_augmentation,
)
from .preprocess_kitti import PreprocessKitti, parse_ground_truth, factory_file
