from keras_object_detection_torch.data.augment import (
    AugmentDraws, MixupDraws, MosaicDraws, augment_batch, mixup_batch,
    mosaic_batch, preprocess_eval_batch, sample_augment_draws,
    sample_mixup_draws, sample_mosaic_draws)
from keras_object_detection_torch.data.pipeline import (DeviceCachedDataset,
                                                        YoloDataset)
from keras_object_detection_torch.data.reader import (list_examples,
                                                      load_example,
                                                      read_yolo_labels)

__all__ = ["AugmentDraws", "DeviceCachedDataset", "MixupDraws", "MosaicDraws",
           "YoloDataset", "augment_batch", "list_examples", "load_example",
           "mixup_batch", "mosaic_batch", "preprocess_eval_batch",
           "read_yolo_labels", "sample_augment_draws", "sample_mixup_draws",
           "sample_mosaic_draws"]
