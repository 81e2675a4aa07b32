from keras_object_detection_torch.eval.evaluator import InferenceModel

__all__ = ["InferenceModel"]
