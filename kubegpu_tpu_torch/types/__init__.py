"""The shared vocabulary of the port's control plane and device layer: its
own copies of the JAX package's ``types/`` (devices with mesh
coordinates, grouped resource paths, node/pod/container records and the
annotation codec).  The wire format is the system's own, byte for byte."""

from kubegpu_tpu_torch.types.resource import (
    ResourcePath,
    ResourceTree,
    RES_TPU,
    RES_TPU_MEM_GIB,
    LEAF_TPU,
    DEVICE_GROUP_PREFIX,
)
from kubegpu_tpu_torch.types.topology import (
    Chip,
    SliceTopology,
    Submesh,
    TpuGeneration,
    enumerate_rectangles,
    coords_bounding_box,
    is_contiguous_submesh,
)
from kubegpu_tpu_torch.types.info import (
    ContainerInfo,
    NodeInfo,
    PodInfo,
    TpuRequest,
)
from kubegpu_tpu_torch.types import annotations

__all__ = [
    "ResourcePath",
    "ResourceTree",
    "RES_TPU",
    "RES_TPU_MEM_GIB",
    "LEAF_TPU",
    "DEVICE_GROUP_PREFIX",
    "Chip",
    "SliceTopology",
    "Submesh",
    "TpuGeneration",
    "enumerate_rectangles",
    "coords_bounding_box",
    "is_contiguous_submesh",
    "ContainerInfo",
    "NodeInfo",
    "PodInfo",
    "TpuRequest",
    "annotations",
]
