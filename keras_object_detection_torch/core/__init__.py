from keras_object_detection_torch.core.anchors import (decode_anchor_grid,
                                                     decode_anchor_targets,
                                                     encode_anchor_grid)
from keras_object_detection_torch.core.boxes import (cxcywh_to_corners,
                                                     iou_cxcywh,
                                                     iou_cxcywh_exact,
                                                     pairwise_iou_cxcywh,
                                                     pairwise_iou_cxcywh_exact)
from keras_object_detection_torch.core.grid import decode_grid, encode_grid

__all__ = ["cxcywh_to_corners", "decode_anchor_grid", "decode_anchor_targets",
           "decode_grid", "encode_anchor_grid", "encode_grid", "iou_cxcywh",
           "iou_cxcywh_exact", "pairwise_iou_cxcywh",
           "pairwise_iou_cxcywh_exact"]
