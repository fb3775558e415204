"""Worker process for the 2-process DCN bring-up test (test_distributed.py).

Each process owns 4 virtual CPU devices; ``jax.distributed.initialize``
glues them into one 8-device global runtime — the localhost stand-in for a
multi-host DCN deployment (same code path: coordinator bootstrap, global
device list, cross-process collectives).

Usage: python dcn_worker.py <rank> <num_processes> <coordinator_port>
Prints "DCN OK ..." on success; "DCN UNSUPPORTED: ..." when this jax build
cannot run cross-process CPU collectives (documented fallback).
"""

import os
import sys

# repo root on sys.path (the script lives in tests/)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    rank = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]

    os.environ["JAX_PLATFORM_NAME"] = "cpu"
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

    import jax
    jax.config.update("jax_platforms", "cpu")
    try:
        # cross-process CPU collectives need the gloo backend where available
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass

    from pde_solver.parallel.distributed import (global_device_mesh,
                                                     initialize_distributed)
    try:
        multi = initialize_distributed(f"localhost:{port}", nproc, rank)
    except Exception as e:
        print(f"DCN UNSUPPORTED: initialize failed: {type(e).__name__}: {e}",
              flush=True)
        return 0
    if not multi or jax.process_count() != nproc:
        print(f"DCN UNSUPPORTED: process_count={jax.process_count()}",
              flush=True)
        return 0
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_global == 4 * nproc, (n_global, n_local)

    import jax.numpy as jnp
    import numpy as np
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = global_device_mesh()

    # cross-process psum over the DCN-spanning mesh
    def local_sum(x):
        return jax.lax.psum(jnp.sum(x), "shard_x")

    fn = jax.jit(shard_map(local_sum, mesh=mesh,
                           in_specs=P("shard_x"), out_specs=P(),
                           check_vma=False))
    # global array from process-local shards (the multi-host data path)
    global_shape = (n_global * 3,)
    local_data = np.full((n_local * 3,), float(rank + 1))
    arr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("shard_x")), local_data, global_shape)
    total = float(fn(arr))
    expected = 4 * 3 * sum(r + 1 for r in range(nproc))
    assert abs(total - expected) < 1e-12, (total, expected)

    # halo exchange across the process boundary: the ppermute neighbor
    # shift parallel.shard.halo_exchange uses, over the DCN-spanning mesh
    def ring(x):
        n = jax.lax.axis_size("shard_x")
        return jax.lax.ppermute(x, "shard_x",
                                [(j, (j + 1) % n) for j in range(n)])

    ring_fn = jax.jit(shard_map(ring, mesh=mesh, in_specs=P("shard_x"),
                                out_specs=P("shard_x"), check_vma=False))
    ids = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("shard_x")),
        np.arange(n_local, dtype=np.float64) + rank * n_local,
        (n_global,))
    shifted = ring_fn(ids)
    # process-local view: this process's shards now hold the values of the
    # devices one step to the left (wrapping), which crossed the process
    # boundary for local device 0
    local_vals = sorted(
        float(s.data[0]) for s in shifted.addressable_shards)
    expected_vals = sorted((np.arange(n_local) + rank * n_local - 1)
                           % n_global)
    assert local_vals == [float(v) for v in expected_vals], (
        local_vals, expected_vals)

    print(f"DCN OK: rank={rank} procs={jax.process_count()} "
          f"global_devices={n_global} psum={total} ppermute ring verified",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
