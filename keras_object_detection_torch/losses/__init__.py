from keras_object_detection_torch.losses.yolo import yolo_v1_loss_terms

__all__ = ["yolo_v1_loss_terms"]
