"""Multi-GPU: the device mesh and the process group (counterpart of
``fabric_tpu/parallel``)."""

from fabric_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, make_mesh_from_config, pad_batch_to_multiple)
