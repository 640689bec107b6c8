from .losses import (
    laplace_loss_terms,
    gaussian_loss_terms,
    custom_l1_loss,
    composite_losses,
    multitask_loss,
    weighted_total,
    LOSS_TASKS_MONO,
    LOSS_TASKS_STEREO,
)
from .datasets import KeypointsDataset, ActivityDataset
from .trainer import Trainer
from .hyp_tuning import HypTuning
