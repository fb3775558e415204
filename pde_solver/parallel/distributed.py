"""Multi-host bring-up: jax.distributed initialization + global mesh.

Single-host multi-device sharding needs nothing from this module —
``parallel.shard`` builds its mesh from ``jax.devices()`` directly.  Across
hosts, JAX requires one ``jax.distributed.initialize`` call per process
before any computation; afterwards ``jax.devices()`` is the *global* device
list and the same shard_map/psum code runs unchanged, with XLA routing
collectives within and across hosts.

The reference has no distributed execution of any kind (single-process stdio
server, fenics_mcp_server.py:4554; SURVEY §5 'distributed communication
backend' row) — this is the replacement for what a cluster FEM
code would bootstrap with MPI_Init.

Environment (mirrors standard JAX multi-host launchers):
  PDE_COORDINATOR   "host:port" of process 0 (JAX default port 1234)
  PDE_NUM_PROCESSES total process count
  PDE_PROCESS_ID    this process's rank

On a machine where nothing tells JAX of the cluster, all three must be
given; on managed clusters JAX can detect them and
``initialize_distributed()`` may be called with no arguments.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from pde_solver.utils.observability import get_logger

_INITIALIZED = False


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Idempotent ``jax.distributed.initialize`` wrapper.

    Returns True when a multi-process runtime is active after the call
    (False for the common single-host case — callers need no branching,
    the global device list is correct either way).
    """
    global _INITIALIZED
    if _INITIALIZED:
        return jax.process_count() > 1

    coordinator_address = coordinator_address or os.environ.get(
        "PDE_COORDINATOR")
    env_np = os.environ.get("PDE_NUM_PROCESSES")
    env_pid = os.environ.get("PDE_PROCESS_ID")
    num_processes = num_processes if num_processes is not None else (
        int(env_np) if env_np else None)
    process_id = process_id if process_id is not None else (
        int(env_pid) if env_pid else None)

    if coordinator_address is None and num_processes is None:
        # Single-host (or auto-detecting managed platform with no explicit
        # config): skip initialize — jax.devices() is already correct.
        _INITIALIZED = True
        return False

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _INITIALIZED = True
    get_logger().info(
        "jax.distributed initialized: process %d/%d, %d local + %d global devices",
        jax.process_index(), jax.process_count(),
        len(jax.local_devices()), len(jax.devices()))
    return jax.process_count() > 1


def global_device_mesh(axis_name: str = "shard_x"):
    """1-D mesh over ALL processes' devices (DCN-spanning when multi-host).

    Use with ``parallel.shard`` exactly like the single-host mesh; data must
    be created per-shard with ``jax.make_array_from_single_device_arrays`` or
    via ``jax.device_put`` of host-local shards on multi-host runs.
    """
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis_name,))
