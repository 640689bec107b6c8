from .loco import (
    init_loco_params,
    init_monoloco_params,
    loco_forward_stacked,
    loco_forward_train_stacked,
    loco_forward,
    loco_forward_train,
    train_keep_masks,
    fold_eval_params,
    folded_forward,
    folded_forward_mc,
    dropout_masks,
    n_dropout_sites,
    round_bf16,
    FoldedLoco,
)
from .checkpoint import (
    save_checkpoint,
    save_train_state,
    load_train_state,
    load_checkpoint,
    convert_torch_state_dict,
    params_from_numpy,
)
