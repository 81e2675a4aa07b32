"""Quantized serving and model export (counterpart of
``keras_object_detection_tpu/export`` ``quantize.py``, ``int8_serving.py``,
``qat.py`` and ``litert.py``)."""

from keras_object_detection_torch.export.int8_serving import (  # noqa: F401
    Int8InferenceModel,
    calibrate_activation_scales,
    select_serving_model,
)
from keras_object_detection_torch.export.litert import (  # noqa: F401
    export_program,
    export_tflite,
    load_program,
)
from keras_object_detection_torch.export.quantize import (  # noqa: F401
    QuantizedInferenceModel,
)
