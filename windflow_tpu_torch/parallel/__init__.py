"""Multi-device and multi-process layer: (kf x wf x sp) meshes of torch
devices, the multi-process layout (kf split along the process boundary)
and the cross-process row channel — the scale-out surface in one
import."""

from .channel import RowReceiver, RowSender, partition_and_ship
from .mesh import (KF_AXIS, SP_AXIS, WF_AXIS, DeviceMesh, MeshStreamStep,
                   MeshWindowedReduce, make_mesh, partition_stream_by_key)
from .multihost import (initialize, local_kf_groups, make_multihost_mesh,
                        process_for_keys)

__all__ = [
    "KF_AXIS", "WF_AXIS", "SP_AXIS", "DeviceMesh", "make_mesh",
    "MeshStreamStep", "MeshWindowedReduce", "partition_stream_by_key",
    "initialize", "make_multihost_mesh", "process_for_keys",
    "local_kf_groups",
    "RowSender", "RowReceiver", "partition_and_ship",
]
