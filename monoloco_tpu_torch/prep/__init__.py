from .preprocess_kitti import parse_ground_truth, factory_file
