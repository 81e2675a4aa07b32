"""Data parallelism (counterpart of ``keras_object_detection_tpu/parallel``):
``mesh`` (the mesh and its shardings), ``distributed`` (the process group
and the collectives) and ``dryrun`` (a multi-rank dry run of the real
families' train steps)."""

from keras_object_detection_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    create_mesh,
    replicated_sharding,
)
