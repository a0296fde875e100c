"""Multi-host (multi-process) runtime for the distributed BA path.

The reference has no multi-machine story at all — its only inter-process
transport is ROS pub/sub on one host (SURVEY.md §2). This design targets
several hosts: one Python process per host, `jax.distributed` for the
coordination service, one global `Mesh` over every device, and the same
landmark-sharded Schur BA (`parallel/dist_ba.py`) jitted over it — XLA lowers
the per-iteration (S, s) psum to collectives, no application-level
networking.

The tests exercise the SAME code path with N CPU processes × D virtual CPU
devices each (`--xla_force_host_platform_device_count`): the coordination
handshake, the global-mesh construction, `make_array_from_callback` shard
placement, and the cross-process psum are identical to the multi-host case;
only the transport differs (gRPC loopback). `scripts/bench_scaling.py
--multiprocess` and `tests/test_multihost.py` drive it.
"""

from __future__ import annotations

import os

import numpy as np


def init_worker(
    coordinator: str,
    num_processes: int,
    process_id: int,
    local_device_count: int = 1,
    platform: str = "cpu",
):
    """Initialize this process as one host of a multi-host job.

    Must run before any JAX backend is touched. Returns the jax module.
    For platform='cpu' each process hosts `local_device_count` virtual
    devices (the test stand-in for a host's chips).
    """
    flags = os.environ.get("XLA_FLAGS", "")
    if (
        platform == "cpu"
        and "xla_force_host_platform_device_count" not in flags
    ):
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={local_device_count}"
        ).strip()
    import jax

    jax.config.update("jax_platforms", platform)
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax


def global_mesh(axis: str = "lm"):
    """One-axis mesh over every device of every process, in process order."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def host_array(full: np.ndarray, mesh, spec):
    """Place a host-replicated numpy array as a global sharded jax.Array.

    Every process holds the SAME full array (problems here are built
    deterministically from a seed); each process donates only the shards
    that live on its local devices. For replicated specs this is a cheap
    local put per device.
    """
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        full.shape, sharding, lambda idx: np.ascontiguousarray(full[idx])
    )


def host_tree(tree_np, mesh, spec_tree):
    """`host_array` over a pytree of (numpy leaves, PartitionSpec leaves)."""
    import jax

    return jax.tree_util.tree_map(
        lambda a, s: host_array(np.asarray(a), mesh, s), tree_np, spec_tree
    )
