"""Multi-device layer: (kf x wf x sp) meshes of torch devices and the
mesh windowed reduction.  The cross-process row channel and the
multi-host layout (the JAX package's ``parallel/{channel,multihost}.py``)
come with items 8b and 9b of ROADMAP.md's Queue 1."""

from .mesh import (KF_AXIS, SP_AXIS, WF_AXIS, DeviceMesh, MeshStreamStep,
                   MeshWindowedReduce, make_mesh, partition_stream_by_key)

__all__ = [
    "KF_AXIS", "WF_AXIS", "SP_AXIS", "DeviceMesh", "make_mesh",
    "MeshStreamStep", "MeshWindowedReduce", "partition_stream_by_key",
]
