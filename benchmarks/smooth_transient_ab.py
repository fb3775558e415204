"""A/B the V(2,1) vs V(2,2) MG cycle on transient MG-PCG stepping.

The flagship df2 rounds use a V(2,1) cycle (benchmarks/df2_sweep.py);
transient stepping solves a much
better-conditioned operator (M + θΔtK) with ~6 warm-started iterations per
step, where the per-iteration V-cycle cost dominates differently.  One
process, in-process env toggle.

Run on the GPU from the repository root:
    python benchmarks/smooth_transient_ab.py
"""

import json
import os
import sys
import time

sys.path.insert(0, ".")


def main():
    import jax.numpy as jnp

    from pde_solver.mesh import box_mesh
    from pde_solver.models import heat

    t0 = time.perf_counter()
    float(jnp.zeros(()))
    print(f"[ab] warmup {time.perf_counter() - t0:.1f}s", flush=True)

    cells, num_steps = 128, 50
    mesh = box_mesh(cells, cells, cells, (0, 0, 0), (1.0, 1.0, 1.0))
    p = heat.HeatProblem(
        mesh=mesh, diffusivity=1.0,
        bc_builder=lambda m: [(m.boundary_mask(), 0.0)],
        T_initial=20.0, dt=0.01, num_steps=num_steps)
    results = {}
    for smooth in ("", "2,1"):
        if smooth:
            os.environ["PDE_MG_SMOOTH"] = smooth
        else:
            os.environ.pop("PDE_MG_SMOOTH", None)
        tag = f"V({smooth or '2,2'})"
        t0 = time.perf_counter()
        _, _, info = heat.solve_heat_problem(p)
        print(f"[ab] {tag} warm {time.perf_counter() - t0:.1f}s "
              f"scan={info['scan_seconds']:.3f}s "
              f"iters={info['cg_iterations']} "
              f"relres={info['relative_residual']:.2e}", flush=True)
        scans = []
        for rep in range(3):
            _, _, info = heat.solve_heat_problem(p)
            scans.append(info["scan_seconds"])
            print(f"[ab] {tag} rep{rep} scan={scans[-1]:.3f}s "
                  f"iters={info['cg_iterations']}", flush=True)
        results[tag] = {"best_scan_s": min(scans),
                        "steps_per_s": num_steps / min(scans),
                        "iters": info["cg_iterations"],
                        "relres": info["relative_residual"]}
    os.environ.pop("PDE_MG_SMOOTH", None)
    print(json.dumps(results, indent=2), flush=True)


if __name__ == "__main__":
    main()
