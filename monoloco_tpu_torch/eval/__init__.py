from .eval_kitti import EvalKitti
from .generate_kitti import GenerateKitti
from .geom_baseline import geometric_baseline, geometric_coordinates
from .stereo_baselines import baselines_association
