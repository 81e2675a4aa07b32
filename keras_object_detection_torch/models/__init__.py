from keras_object_detection_torch.models.convert import flax_to_torch
from keras_object_detection_torch.models.yolo import YoloV1, build_model

__all__ = ["YoloV1", "build_model", "flax_to_torch"]
