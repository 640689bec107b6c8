from .preprocess import (
    preprocess_monoloco,
    preprocess_monstereo,
    preprocess_pifpaf,
    prepare_pif_kps,
    load_calibration,
    factory_for_gt,
)
from .decode import (
    unnormalize_bi,
    laplace_sampling,
    laplace_uniforms,
    extract_outputs,
    extract_outputs_mono,
    extract_labels,
    extract_labels_aux,
    cluster_outputs,
    filter_outputs,
)
from .engine import Loco, median_disparity
