from .eval_kitti import EvalKitti
from .generate_kitti import GenerateKitti
