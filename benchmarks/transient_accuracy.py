"""Quantify the pure-float32 transient-scan trajectory error at scale.

A pure-float32 scan (``precision="f32"``) keeps the state in f32; the
default accelerator path (``"mixed"``) keeps it in f64 with f32
corrections.  This study bounds what pure f32 costs:

  e_f32  = ‖u_f32(t) − u_f64(t)‖ / ‖u_f64(t)‖      (arithmetic error)
  e_dt   = ‖u_f64,dt(t) − u_f64,dt/2(t)‖ / ‖·‖      (time-discretization error)

The claim being validated: e_f32 ≪ e_dt at every snapshot, i.e. f32
arithmetic is invisible under the backward-Euler discretization error.
Run:  JAX_PLATFORMS=cpu python benchmarks/transient_accuracy.py [cells]
(defaults to 40³ ≈ 69k DOF).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def trajectory(mesh, precision, dt, num_steps, tol):
    from pde_solver.config import SolverConfig
    from pde_solver.models import heat

    p = heat.HeatProblem(
        mesh=mesh, diffusivity=1.0,
        bc_builder=lambda m: [(m.boundary_mask(), 0.0)],
        T_initial=20.0, dt=dt, num_steps=num_steps)
    cfg = SolverConfig(precision=precision, transient_inner_tol=tol,
                       snapshot_dtype="f64")
    t0 = time.perf_counter()
    times, values, info = heat.solve_heat_problem(p, config=cfg)
    print(f"  precision={precision} dt={dt:g}: {time.perf_counter()-t0:.1f}s, "
          f"CG iters {info['cg_iterations']}, relres "
          f"{info['relative_residual']:.1e}", flush=True)
    return np.asarray(values, dtype=np.float64)


def rel(a, b):
    n = np.linalg.norm(b.reshape(b.shape[0], -1), axis=1)
    d = np.linalg.norm((a - b).reshape(b.shape[0], -1), axis=1)
    return d / np.maximum(n, 1e-300)


def main():
    cells = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    from pde_solver.mesh import box_mesh

    mesh = box_mesh(cells, cells, cells, (0, 0, 0), (1.0, 1.0, 1.0))
    num_steps, dt = 50, 0.002
    print(f"3D heat {cells}³ cells = {mesh.num_nodes} DOF, "
          f"{num_steps} BE steps, dt={dt}", flush=True)

    u64 = trajectory(mesh, "f64", dt, num_steps, tol=1e-12)
    u32 = trajectory(mesh, "f32", dt, num_steps, tol=1e-6)
    # halved dt, f64 — the time-discretization yardstick (compare at
    # matching physical times: every 2nd snapshot)
    u64h = trajectory(mesh, "f64", dt / 2, 2 * num_steps, tol=1e-12)

    e32 = rel(u32, u64)[1:]
    edt = rel(u64h[::2], u64)[1:]
    print(f"\nf32-vs-f64 trajectory error:    max {e32.max():.2e}  "
          f"final {e32[-1]:.2e}")
    print(f"time-discretization (dt vs dt/2): max {edt.max():.2e}  "
          f"final {edt[-1]:.2e}")
    print(f"ratio e_f32/e_dt per snapshot:   max "
          f"{np.max(e32 / np.maximum(edt, 1e-300)):.3f}")
    ok = bool(np.all(e32 < 0.05 * edt))
    print(f"f32 arithmetic ≤ 5% of time-discretization error everywhere: {ok}")


if __name__ == "__main__":
    main()
