from keras_object_detection_torch.core.anchors import (decode_anchor_grid,
                                                     decode_anchor_targets,
                                                     encode_anchor_grid)
from keras_object_detection_torch.core.boxes import (cxcywh_to_corners,
                                                     iou_cxcywh,
                                                     iou_cxcywh_exact,
                                                     pairwise_iou_cxcywh,
                                                     pairwise_iou_cxcywh_exact)
from keras_object_detection_torch.core.fpn import (decode_fpn_grids,
                                                   decode_fpn_targets,
                                                   encode_fpn_grids,
                                                   fpn_grid_sizes,
                                                   partition_anchors)
from keras_object_detection_torch.core.grid import decode_grid, encode_grid

__all__ = ["cxcywh_to_corners", "decode_anchor_grid", "decode_anchor_targets",
           "decode_fpn_grids", "decode_fpn_targets", "decode_grid",
           "encode_anchor_grid", "encode_fpn_grids", "encode_grid",
           "fpn_grid_sizes", "iou_cxcywh", "iou_cxcywh_exact",
           "pairwise_iou_cxcywh", "pairwise_iou_cxcywh_exact",
           "partition_anchors"]
