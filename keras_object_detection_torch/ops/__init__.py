from keras_object_detection_torch.ops.cuda_nms import (
    auto_batched_non_max_suppression, cuda_batched_non_max_suppression)
from keras_object_detection_torch.ops.nms import (batched_non_max_suppression,
                                                  non_max_suppression,
                                                  top_k_candidates)

__all__ = ["auto_batched_non_max_suppression", "batched_non_max_suppression",
           "cuda_batched_non_max_suppression", "non_max_suppression",
           "top_k_candidates"]
