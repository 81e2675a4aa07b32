from keras_object_detection_torch.ops.cuda_nms import (
    auto_batched_non_max_suppression, cuda_batched_non_max_suppression)
from keras_object_detection_torch.ops.map import (COCO_IOU_THRESHOLDS,
                                                  MeanAveragePrecision,
                                                  average_precision_per_class,
                                                  mean_average_precision,
                                                  mean_average_precision_multi)
from keras_object_detection_torch.ops.nms import (
    batched_fast_non_max_suppression, batched_non_max_suppression,
    fast_non_max_suppression, non_max_suppression, top_k_candidates)

__all__ = ["COCO_IOU_THRESHOLDS", "MeanAveragePrecision",
           "auto_batched_non_max_suppression", "average_precision_per_class",
           "batched_fast_non_max_suppression", "batched_non_max_suppression",
           "cuda_batched_non_max_suppression", "fast_non_max_suppression",
           "mean_average_precision", "mean_average_precision_multi",
           "non_max_suppression", "top_k_candidates"]
