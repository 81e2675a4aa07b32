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

__all__ = ["CheckpointManager", "StepDraws", "TrainState", "Trainer",
           "average_checkpoints", "create_train_state", "make_eval_step",
           "make_train_step", "multiscale_grid", "run_dataset_eval",
           "sample_step_draws", "set_learning_rate", "validate_multiscale"]
