from .preprocess import (
    preprocess_monoloco,
    preprocess_pifpaf,
    prepare_pif_kps,
    load_calibration,
    factory_for_gt,
)
from .decode import unnormalize_bi, extract_outputs, extract_outputs_mono
from .engine import Loco
