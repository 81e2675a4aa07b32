from keras_object_detection_torch.data.augment import (AugmentDraws,
                                                       augment_batch,
                                                       preprocess_eval_batch,
                                                       sample_augment_draws)
from keras_object_detection_torch.data.pipeline import (DeviceCachedDataset,
                                                        YoloDataset)

__all__ = ["AugmentDraws", "DeviceCachedDataset", "YoloDataset",
           "augment_batch", "preprocess_eval_batch", "sample_augment_draws"]
