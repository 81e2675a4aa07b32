from keras_object_detection_torch.models.backbones import (BACKBONES,
                                                           MobileNetV2Backbone,
                                                           VGG16Backbone)
from keras_object_detection_torch.models.convert import flax_to_torch
from keras_object_detection_torch.models.darknet import (ARCHITECTURE_CONFIG,
                                                         DARKNET_TINY_CONFIG,
                                                         DarknetBackbone)
from keras_object_detection_torch.models.yolo import YoloV1, build_model

__all__ = ["ARCHITECTURE_CONFIG", "BACKBONES", "DARKNET_TINY_CONFIG",
           "DarknetBackbone", "MobileNetV2Backbone", "VGG16Backbone",
           "YoloV1", "build_model", "flax_to_torch"]
