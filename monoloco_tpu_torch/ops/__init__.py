from .fused_mlp import (
    quant_weight,
    pack_folded_weights_w8,
    dyn8_forward_plain,
    fused_loco_forward_dyn8,
    fused_loco_forward_dyn8_resident,
    fused_loco_forward_dyn8_auto,
    dyn8_resident_eligible,
    launches,
)
