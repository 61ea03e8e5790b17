"""Multi-host (DCN) plumbing for the dist package.

Single-host multi-device rendering needs nothing beyond dist/mesh.py
(XLA drives all local devices; on GPUs the psum goes through NCCL).
Across HOSTS, JAX requires the
distributed runtime before any device use; this module wraps that
bootstrap and the two places where the row-sharded renderer touches
process-locality:

  - creating the sharded state from process-local zeros
  - gathering the image / writing checkpoints (each process sees only its
    addressable shards)

Design notes (scaling-book recipe): the pixel rows stay tile-disjoint, so
steady-state communication is still ZERO — DCN only carries the scalar
Mrays psum and the final frame gather. A many-host deployment renders
with the exact same shard_map program as one device.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np

_initialized = False


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed for a multi-process render.

    Arguments default to the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, or a
    cluster-autodetected environment). Returns True when a multi-process
    runtime is active, False for the single-process case. Idempotent."""
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes in (None, 1):
        # single process: nothing to initialize
        _initialized = True
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    return True


def make_global_array(mesh, spec, local_np: np.ndarray):
    """Build a (possibly multi-host) global array from this process's data.

    ``local_np`` holds the GLOBAL value when the mesh is fully addressable
    (single host — plain device_put), or this process's row slab when it
    is not."""
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    if all(d.process_index == jax.process_index()
           for d in mesh.devices.flat):
        return jax.device_put(local_np, sharding)
    return jax.make_array_from_process_local_data(sharding, local_np)


def fetch_global(arr) -> np.ndarray:
    """Host copy of a global array: direct when fully addressable, an
    all-gather over DCN otherwise (frame export only — never on the
    steady-state render path)."""
    if getattr(arr, "is_fully_addressable", True):
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))
