from keras_object_detection_torch.train.checkpoint import (CheckpointManager,
                                                           average_checkpoints)
from keras_object_detection_torch.train.loop import (StepDraws, TrainState,
                                                     Trainer,
                                                     create_train_state,
                                                     make_eval_step,
                                                     make_train_step,
                                                     multiscale_grid,
                                                     run_dataset_eval,
                                                     sample_step_draws,
                                                     set_learning_rate,
                                                     validate_multiscale)
from keras_object_detection_torch.train.metrics_logger import MetricLogger
from keras_object_detection_torch.train.schedules import (
    cosine_annealing_restarts_lrs, epoch_schedule, piecewise_warmup_lr)

__all__ = ["CheckpointManager", "MetricLogger", "StepDraws", "TrainState",
           "Trainer", "average_checkpoints", "cosine_annealing_restarts_lrs",
           "create_train_state", "epoch_schedule", "make_eval_step",
           "make_train_step", "multiscale_grid", "piecewise_warmup_lr",
           "run_dataset_eval", "sample_step_draws", "set_learning_rate",
           "validate_multiscale"]
