"""Profiling and visualisation (counterpart of
``keras_object_detection_tpu/utils``): ``profiling`` (``torch.profiler``
traces and their parsing) and ``viz`` (tagged images). XLA's compile cache
(``utils/jax_cache.py``) has no counterpart: eager PyTorch compiles no
program, and the port's only build cache is ``ops/_build.py``'s nvcc
output under ``build/kernels/``."""
