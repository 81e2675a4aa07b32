from keras_object_detection_torch.data.augment import (AugmentDraws,
                                                       augment_batch,
                                                       preprocess_eval_batch,
                                                       sample_augment_draws)

__all__ = ["AugmentDraws", "augment_batch", "preprocess_eval_batch",
           "sample_augment_draws"]
