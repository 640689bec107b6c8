from .loco import (
    init_loco_params,
    loco_forward,
    fold_eval_params,
    folded_forward,
    FoldedLoco,
)
from .checkpoint import (
    save_checkpoint,
    load_checkpoint,
    convert_torch_state_dict,
    params_from_numpy,
)
