"""Float64 refinement around float32 MG-PCG, round by round.

With a multigrid hierarchy, a ``mixed`` solve runs the double-float32
F-cycle (``multigrid.solve_fcycle_df2``) on one device and float64 MG-PCG
when sharded.  This script runs the plain scheme both replace — each round
solves for the float64 host residual with float32 MG-PCG (to ``--inner-tol``)
and adds the correction in float64 — on one device or sharded over
``--shard`` devices, and prints the true relative residual after each
round, so that a stall of float32 refinement shows directly.

    python benchmarks/f32_refinement.py [--cells 160 64 64] [--shard N]

Prints one line per round and a JSON summary line last.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def refine(cells, shard=0, rounds=7, inner_tol=1e-4, maxiter=300,
           log=print):
    """Rounds of host-f64 refinement with f32 MG-PCG inner solves on the
    flagship cantilever at ``cells``; returns [(relres, iterations), ...],
    the first entry the start (x = 0)."""
    from benchmarks.spmv_bench import cantilever_problem
    from pde_solver.ops import multigrid as mg
    from pde_solver.ops.linsolve import np_stencil_apply, prepare_system

    mesh, K, bc, b, builder = cantilever_problem(cells)
    sysm = prepare_system(K, mesh, bc, b, 3)
    h = mg.build_hierarchy_cached(mesh, sysm, builder, vdim=3,
                                  dtype=jnp.float32, cache_key=sysm.ckey)
    if shard > 1:
        from pde_solver.parallel.shard import device_mesh
        from pde_solver.parallel.shard_mg import shard_hierarchy

        solver = shard_hierarchy(h, device_mesh(shard))

        def inner(r32):
            return solver.solve(r32, None, tol=inner_tol, maxiter=maxiter)
    else:
        def inner(r32):
            return mg.solve_mg(h, r32, None, inner_tol, maxiter)

    A = dict(zip(sysm.offsets, sysm.weights))
    bnorm = float(np.linalg.norm(sysm.b_hat))
    x = np.zeros_like(sysm.b_hat)
    r = sysm.b_hat
    out = [(1.0, 0)]
    for k in range(1, rounds + 1):
        scale = float(np.abs(r).max())
        t0 = time.perf_counter()
        d32, its, _ = inner(np.asarray(r / scale, np.float32))
        d32 = np.asarray(d32, np.float64)
        sec = time.perf_counter() - t0
        x = x + scale * d32
        r = sysm.b_hat - np_stencil_apply(A, x, 3, 3)
        out.append((float(np.linalg.norm(r)) / bnorm, int(its)))
        log(f"round {k}: relres {out[-1][0]:.3e}, inner iterations "
            f"{out[-1][1]}, {sec:.3f} s")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", type=int, nargs=3, default=[160, 64, 64])
    ap.add_argument("--shard", type=int, default=0,
                    help="devices to shard the inner solves over (0: one)")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--inner-tol", type=float, default=1e-4)
    args = ap.parse_args()
    devs = jax.devices()
    print(f"{len(devs)} x {devs[0].device_kind}", flush=True)
    hist = refine(tuple(args.cells), args.shard, args.rounds, args.inner_tol,
                  log=lambda m: print(m, flush=True))
    print(json.dumps({
        "cells": args.cells, "shard": args.shard,
        "inner_tol": args.inner_tol,
        "relres": [h[0] for h in hist[1:]],
        "inner_iterations": [h[1] for h in hist[1:]],
        "device_kind": devs[0].device_kind}), flush=True)


if __name__ == "__main__":
    main()
