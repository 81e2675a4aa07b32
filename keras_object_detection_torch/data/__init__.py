from keras_object_detection_torch.data.augment import (
    AugmentDraws, MixupDraws, MosaicDraws, augment_batch, mixup_batch,
    mosaic_batch, preprocess_eval_batch, sample_augment_draws,
    sample_mixup_draws, sample_mosaic_draws)
from keras_object_detection_torch.data.pipeline import (DeviceCachedDataset,
                                                        YoloDataset)

__all__ = ["AugmentDraws", "DeviceCachedDataset", "MixupDraws", "MosaicDraws",
           "YoloDataset", "augment_batch", "mixup_batch", "mosaic_batch",
           "preprocess_eval_batch", "sample_augment_draws",
           "sample_mixup_draws", "sample_mosaic_draws"]
