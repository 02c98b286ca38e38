"""Training harness exports (the TPU package's train/__init__.py surface;
its step factories `make_train_step` / `make_eval_step` build jitted
closures, and their counterparts here are the functions `train_step` /
`eval_step`)."""

from .cv import class_weight_vector, test_models, train_cv
from .fusion import train_fusion_cv
from .loop import (TrainState, create_train_state, eval_step, make_epoch_schedule,
                   make_optimizer, train_step)
from .metrics import (METRIC_KEYS, calculate_metrics, calculate_metrics_multiclass,
                      model_selection_score)
from .single_split import train_unet_classifier

__all__ = [
    "train_cv", "test_models", "class_weight_vector", "train_fusion_cv",
    "train_unet_classifier", "TrainState", "create_train_state",
    "make_epoch_schedule", "eval_step", "make_optimizer",
    "train_step", "METRIC_KEYS", "calculate_metrics",
    "calculate_metrics_multiclass", "model_selection_score",
]
