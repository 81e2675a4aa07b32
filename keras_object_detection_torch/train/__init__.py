from keras_object_detection_torch.train.loop import (TrainState,
                                                     create_train_state,
                                                     make_train_step,
                                                     set_learning_rate)

__all__ = ["TrainState", "create_train_state", "make_train_step",
           "set_learning_rate"]
