from keras_object_detection_torch.eval.evaluator import (Evaluator,
                                                       InferenceModel,
                                                       load_serving_state)

__all__ = ["Evaluator", "InferenceModel", "load_serving_state"]
