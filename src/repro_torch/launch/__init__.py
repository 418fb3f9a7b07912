"""Tensor-parallel topology of the port: device meshes and the partition
rules that split the dense family's parameters and caches over them."""
from repro_torch.launch.mesh import Mesh, make_mesh, pod_meshes
from repro_torch.launch.partition import (kernel_decode_support,
                                          local_config, shard_params)

__all__ = [
    "Mesh",
    "kernel_decode_support",
    "local_config",
    "make_mesh",
    "pod_meshes",
    "shard_params",
]
