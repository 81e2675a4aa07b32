from keras_object_detection_torch.train.checkpoint import (CheckpointManager,
                                                           average_checkpoints)
from keras_object_detection_torch.train.loop import (TrainState, Trainer,
                                                     create_train_state,
                                                     make_eval_step,
                                                     make_train_step,
                                                     run_dataset_eval,
                                                     set_learning_rate)

__all__ = ["CheckpointManager", "TrainState", "Trainer", "average_checkpoints",
           "create_train_state", "make_eval_step", "make_train_step",
           "run_dataset_eval", "set_learning_rate"]
