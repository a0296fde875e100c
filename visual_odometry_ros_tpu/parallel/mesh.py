"""Device-mesh helpers for distributed VO.

The reference's only 'distribution' is ROS pub/sub (SURVEY.md §2 parallelism
inventory); this framework replaces it with a jax.sharding.Mesh and XLA
collectives (NCCL between GPUs). One mesh axis ('lm') shards the landmark/map
blocks; keyframe poses are replicated (they are tiny and every shard needs
them for Hessian assembly).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

LM_AXIS = "lm"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (LM_AXIS,))


def landmark_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(LM_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, devices: int) -> int:
    return ((n + devices - 1) // devices) * devices
