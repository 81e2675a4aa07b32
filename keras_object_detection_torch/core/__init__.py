from keras_object_detection_torch.core.boxes import (cxcywh_to_corners,
                                                     iou_cxcywh,
                                                     pairwise_iou_cxcywh)
from keras_object_detection_torch.core.grid import decode_grid

__all__ = ["cxcywh_to_corners", "decode_grid", "iou_cxcywh",
           "pairwise_iou_cxcywh"]
