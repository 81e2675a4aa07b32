"""PyTorch / CUDA port of keras_object_detection_tpu for NVIDIA Hopper.

Imports torch, numpy and the standard library only. Public functions keep
the JAX package's layouts: NHWC uint8 images in, ``(B, S, S, C + 5B)`` grids
out of the model, ``(B, N, 6)`` rows ``[cls, conf, cx, cy, w, h]`` through
decode and NMS.
"""

__version__ = "0.1.0"

from keras_object_detection_torch import config  # noqa: F401
from keras_object_detection_torch.config import (Config, EvalConfig,
                                                 GridConfig, ModelConfig,
                                                 test_model_config,
                                                 tiny_cpu_config,
                                                 voc_full_config)

__all__ = ["Config", "EvalConfig", "GridConfig", "ModelConfig", "config",
           "test_model_config", "tiny_cpu_config", "voc_full_config"]
