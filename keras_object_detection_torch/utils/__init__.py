"""Profiling and visualisation (counterpart of
``keras_object_detection_tpu/utils``): ``profiling`` (``torch.profiler``
traces and their parsing) and ``viz`` (tagged images; cv2 is imported
when an image is drawn). XLA's compile cache (``utils/jax_cache.py``) has
no counterpart: eager PyTorch compiles no program, and the port's only
build cache is ``ops/_build.py``'s nvcc output under ``build/kernels/``."""

from keras_object_detection_torch.utils.viz import (  # noqa: F401
    get_grid_tagged_img,
    get_tagged_img,
)
