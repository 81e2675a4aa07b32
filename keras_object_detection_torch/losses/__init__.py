from keras_object_detection_torch.losses.yolo import (YoloV1Loss,
                                                      yolo_v1_loss,
                                                      yolo_v1_loss_terms)
from keras_object_detection_torch.losses.yolov2 import yolo_v2_loss_terms
from keras_object_detection_torch.losses.yolov3 import yolo_v3_loss_terms

__all__ = ["YoloV1Loss", "yolo_v1_loss", "yolo_v1_loss_terms",
           "yolo_v2_loss_terms", "yolo_v3_loss_terms"]
