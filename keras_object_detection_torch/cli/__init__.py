"""The port's command lines: ``python -m keras_object_detection_torch.cli.train``
and ``python -m keras_object_detection_torch.cli.evaluate``."""
