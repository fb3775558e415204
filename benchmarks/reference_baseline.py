#!/usr/bin/env python
"""Measure the reference-class solve cost for every BASELINE config.

VERDICT r3 item 3: bench.py's ``vs_baseline`` denominators were invented
constants.  This script MEASURES them: the reference calls FEniCS
``solve(a == L, u, bc)`` with default parameters for every solve and every
time step (`/root/reference/fenics_mcp_server.py:309-318` re-solves with no
stored factorization), i.e. reference-class cost = fresh direct
factorization + triangular solve of the SAME discrete system, each call.

Methodology (all on this host's single core, like-for-like with what the
reference would get here):

* The discrete operator is identical to ours by construction
  (tests/reference_fem.py agrees with the stencil assembly to 1e-9; the
  golden-path tests pin that).  For large meshes the matrix is built from
  the stencil (vectorized) because the surrogate's per-element Python loop
  would time Python, not the reference's C++ assembly — so ASSEMBLY IS NOT
  CHARGED to the reference at all (conservative: the real reference
  re-assembles every step too).
* Solve cost = ``scipy.sparse.linalg.spsolve`` (SuperLU — the same
  UMFPACK/SuperLU class FEniCS' default LU uses), timed per call.
* Config 5 (2M-DOF 3D elasticity) cannot be LU-factorized at bench size
  (3D fill-in: the ladder below hits ~10 GB around 400k DOF); the
  denominator extrapolates a measured size ladder with a fitted power law
  t = c·N^alpha, and the fit + ladder are recorded so the number is
  auditable.

Run:  JAX_PLATFORMS=cpu JAX_PLATFORM_NAME=cpu python benchmarks/reference_baseline.py
Writes benchmarks/reference_baseline.json and prints a markdown table for
BASELINE.md.
"""

import json
import os
import sys
import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = {}


def stencil_to_csr(sysm, node_shape, vdim):
    """Scaled stencil → CSR (same construction as linsolve._host_direct_solve;
    the flat-shift zero invariant makes flat column arithmetic exact)."""
    N = int(np.prod(node_shape))
    strides = []
    acc = 1
    for s in reversed(node_shape):
        strides.append(acc)
        acc *= s
    strides = list(reversed(strides))
    base = np.arange(N)
    rows_l, cols_l, vals_l = [], [], []
    for off, W in zip(sysm.offsets, sysm.weights):
        delta = int(sum(o * st for o, st in zip(off, strides)))
        cols = base + delta
        valid = (cols >= 0) & (cols < N)
        Wf = (np.asarray(W, np.float64).reshape(N, vdim, vdim) if vdim > 1
              else np.asarray(W, np.float64).reshape(N, 1, 1))
        r, c = base[valid], cols[valid]
        for a in range(vdim):
            for b_ in range(vdim):
                rows_l.append(r * vdim + a)
                cols_l.append(c * vdim + b_)
                vals_l.append(Wf[valid, a, b_])
    n = N * vdim
    A = sp.csr_matrix((np.concatenate(vals_l),
                       (np.concatenate(rows_l), np.concatenate(cols_l))),
                      shape=(n, n))
    return A, np.asarray(sysm.b_hat, np.float64).reshape(-1)


def time_fresh_solves(A, b, reps=3, label=""):
    """Fresh spsolve per call — the reference's per-call behavior."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        x = spla.spsolve(A.tocsc(), b)
        ts.append(time.perf_counter() - t0)
    best = min(ts)
    rel = float(np.linalg.norm(b - A @ x) / max(np.linalg.norm(b), 1e-300))
    print(f"  {label}: fresh LU+solve best of {reps}: {best*1e3:.1f} ms "
          f"(relres {rel:.1e})", flush=True)
    return best


def heat_system(cells, extent, dt):
    """Scaled (M + dt K) backward-Euler step system, zero-Dirichlet."""
    from pde_solver.mesh import box_mesh, interval_mesh, rectangle_mesh
    from pde_solver.ops import assembly
    from pde_solver.ops.bc import DirichletBC, all_boundary
    from pde_solver.ops.linsolve import prepare_system

    if len(cells) == 1:
        mesh = interval_mesh(cells[0], 0.0, extent[0])
    elif len(cells) == 2:
        mesh = rectangle_mesh(*cells, (0.0, 0.0), extent)
    else:
        mesh = box_mesh(*cells, (0, 0, 0), extent)
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    A = {off: M.get(off, 0.0) + dt * W for off, W in K.items()}
    for off, W in M.items():
        if off not in A:
            A[off] = W
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    rhs = np.ones(mesh.node_shape)
    sysm = prepare_system(A, mesh, bc, rhs, 1)
    return stencil_to_csr(sysm, mesh.node_shape, 1) + (mesh,)


def elasticity_system(cells, extent, E, nu, mode, body):
    from pde_solver.mesh import box_mesh, rectangle_mesh
    from pde_solver.models.elasticity import lame_parameters
    from pde_solver.ops import assembly
    from pde_solver.ops.bc import DirichletBC
    from pde_solver.ops.linsolve import prepare_system

    d = len(cells)
    lam, mu = lame_parameters(E, nu, mode)
    if d == 2:
        mesh = rectangle_mesh(*cells, (0.0, 0.0), extent)
    else:
        mesh = box_mesh(*cells, (0, 0, 0), extent)
    K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
    b = assembly.assemble_vector_load(mesh, np.array(body))
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=d)
    sysm = prepare_system(K, mesh, bc, b, d)
    return stencil_to_csr(sysm, mesh.node_shape, d) + (mesh,)


def bench_config1_heat1d():
    """256-node rod, backward Euler: reference re-solves per step (full
    surrogate loop is cheap enough in 1D to time assembly too)."""
    print("[config 1] heat1d 256 nodes, fresh solve per BE step", flush=True)
    A, b, mesh = heat_system((255,), (2.0,), 0.05)
    per_solve = time_fresh_solves(A, b, reps=20, label="256-node tridiag")
    # charge ONLY linear algebra (assembly uncharged — conservative)
    steps_s = 1.0 / per_solve
    RESULTS["heat1d_steps_per_s"] = {
        "value": round(steps_s, 1),
        "how": "fresh scipy spsolve of (M+dtK) per step, assembly uncharged",
    }


def bench_config2_bar1d():
    print("[config 2] bar1d 256 nodes, static solve", flush=True)
    from tests.reference_fem import assemble, assemble_load, build_simplices

    # time the SURROGATE end-to-end once for the record (per-element Python
    # assembly — not charged), then the linear-algebra-only denominator
    t0 = time.perf_counter()
    verts, cells_arr = build_simplices((255,), (0.0,), (2.0,))
    EA = 70e9 * 0.01
    Kb = assemble(verts, cells_arr, "stiffness",
                  weight=lambda qp: np.full(len(qp), EA))
    fb = assemble_load(verts, cells_arr, f=lambda qp: np.full(len(qp), 500.0))
    asm_s = time.perf_counter() - t0
    fixed = np.array([0])
    free = np.setdiff1d(np.arange(verts.shape[0]), fixed)
    Kff = Kb[np.ix_(free, free)].tocsc()
    per_solve = time_fresh_solves(sp.csr_matrix(Kff), fb[free], reps=20,
                                  label="255-dof bar")
    print(f"  (surrogate per-element assembly: {asm_s*1e3:.0f} ms — "
          f"Python-loop, not charged)", flush=True)
    RESULTS["bar1d_solve_ms"] = {
        "value": round(per_solve * 1e3, 3),
        "how": "fresh scipy spsolve of the fixed-free K, assembly uncharged",
    }


def bench_config3_heat2d():
    print("[config 3] heat2d 128^2, fresh solve per step", flush=True)
    A, b, mesh = heat_system((128, 128), (1.0, 1.0), 0.001)
    per_solve = time_fresh_solves(A, b, reps=5, label="128^2 BE step")
    RESULTS["heat2d_steps_per_s"] = {
        "value": round(1.0 / per_solve, 2),
        "how": "fresh scipy spsolve of (M+dtK) per step, assembly uncharged",
    }


def bench_config4_elast2d():
    print("[config 4] elast2d 256^2 plane stress static", flush=True)
    A, b, mesh = elasticity_system((256, 256), (1.0, 1.0), 210e9, 0.3,
                                   "plane_stress", [0.0, -7.65e4])
    per_solve = time_fresh_solves(A, b, reps=3, label="132k-DOF plate")
    RESULTS["elast2d_solve_ms"] = {
        "value": round(per_solve * 1e3, 1),
        "how": "fresh scipy spsolve (SuperLU), assembly uncharged",
    }


def bench_config5_elast3d():
    """2M-DOF 3D cantilever: LU ladder + power-law extrapolation."""
    print("[config 5] elast3d cantilever ladder → extrapolate to 2M DOF",
          flush=True)
    ladder = [(16, 8, 8), (24, 12, 12), (32, 16, 16), (48, 20, 20)]
    sizes, times = [], []
    for cells in ladder:
        try:
            A, b, mesh = elasticity_system(cells, (1.0, 0.2, 0.2), 210e9, 0.3,
                                           "3d", [0.0, 0.0, -9.81 * 7800.0])
        except MemoryError:
            print(f"  {cells}: assembly OOM — stopping ladder", flush=True)
            break
        n = A.shape[0]
        try:
            per_solve = time_fresh_solves(A, b, reps=1,
                                          label=f"{cells} = {n} DOF")
        except MemoryError:
            print(f"  {cells}: LU fill-in OOM — stopping ladder", flush=True)
            break
        sizes.append(n)
        times.append(per_solve)
        if per_solve > 600.0:
            print("  ladder rung exceeded 600 s — stopping", flush=True)
            break
    # fit t = c * N^alpha on the ladder (3D nested-dissection LU is
    # O(N^2) flops; the measured alpha is recorded with the fit)
    lg_n, lg_t = np.log(np.array(sizes)), np.log(np.array(times))
    alpha, lg_c = np.polyfit(lg_n, lg_t, 1)
    n_target = 2_040_675
    t_target = float(np.exp(lg_c) * n_target ** alpha)
    print(f"  fit: t = {np.exp(lg_c):.3e} * N^{alpha:.2f}  →  "
          f"t({n_target}) ≈ {t_target:.0f} s", flush=True)
    RESULTS["elast3d_2M_solve_s"] = {
        "value": round(t_target, 1),
        "how": (f"power-law extrapolation t=c*N^alpha of a fresh-LU ladder; "
                f"alpha={alpha:.2f}"),
        "ladder_dofs": sizes,
        "ladder_seconds": [round(t, 2) for t in times],
    }


def bench_heat3d_secondary():
    """heat3d 64^3 (275k DOF) and 128^3 (2.1M): BE steps/s reference-class."""
    print("[secondary] heat3d 3D BE step ladder", flush=True)
    ladder = [(24,) * 3, (32,) * 3, (40,) * 3, (48,) * 3]
    sizes, times = [], []
    for cells in ladder:
        A, b, mesh = heat_system(cells, (1.0, 1.0, 1.0), 0.01)
        n = A.shape[0]
        try:
            per_solve = time_fresh_solves(A, b, reps=1,
                                          label=f"{cells[0]}^3 = {n} DOF")
        except MemoryError:
            print(f"  {cells}: LU OOM — stopping ladder", flush=True)
            break
        sizes.append(n)
        times.append(per_solve)
        if per_solve > 600.0:
            break
    lg_n, lg_t = np.log(np.array(sizes)), np.log(np.array(times))
    alpha, lg_c = np.polyfit(lg_n, lg_t, 1)
    for name, n_target in (("heat3d_64cubed_steps_per_s", 65 ** 3),
                           ("heat3d_128cubed_steps_per_s", 129 ** 3)):
        t_target = float(np.exp(lg_c) * n_target ** alpha)
        RESULTS[name] = {
            "value": round(1.0 / t_target, 4),
            "how": (f"1 / extrapolated fresh-LU BE step; alpha={alpha:.2f}"),
        }
        print(f"  → {name}: {1.0/t_target:.3f} steps/s "
              f"({t_target:.1f} s/step)", flush=True)
    RESULTS["heat3d_ladder"] = {"dofs": sizes,
                                "seconds": [round(t, 3) for t in times],
                                "alpha": round(float(alpha), 3)}


def _time_jacobi_cg(A, b, rtol=1e-6, cap_s=600.0, label=""):
    """Charitable iterative reference class: a PETSc-Krylov-configured user
    (the reference's actual `solve(a==L)` default is LU).  The system here
    is already Jacobi-scaled (identity diagonal), so plain CG IS Jacobi-PCG.
    Returns (seconds, converged) — seconds is a LOWER bound if the cap hit."""
    A = A.tocsr()
    bnorm = np.linalg.norm(b)
    t0 = time.perf_counter()
    state = {"k": 0}

    class _Cap(Exception):
        pass

    def cb(xk):
        state["k"] += 1
        if time.perf_counter() - t0 > cap_s:
            raise _Cap

    try:
        x, info = spla.cg(A, b, rtol=rtol, maxiter=200000, callback=cb)
        dt = time.perf_counter() - t0
        converged = info == 0
    except _Cap:
        dt = time.perf_counter() - t0
        converged = False
    rel = None
    if converged:
        rel = float(np.linalg.norm(b - A @ x) / max(bnorm, 1e-300))
    print(f"  {label}: Jacobi-CG {'converged' if converged else 'CAPPED'} "
          f"in {dt:.1f}s, {state['k']} iters"
          + (f", relres {rel:.1e}" if rel is not None else ""), flush=True)
    return dt, converged


def bench_iterative():
    """Iterative-class denominators for the configs where fresh-LU is
    off-scale (config 5 and the 3D transients)."""
    print("[iterative] heat3d 64^3 BE step (cold Jacobi-CG, rtol 1e-6)",
          flush=True)
    A, b, _ = heat_system((64,) * 3, (1.0, 1.0, 1.0), 0.01)
    s64, conv = _time_jacobi_cg(A, b, label="64^3 BE step")
    RESULTS["heat3d_64cubed_iterative_steps_per_s"] = {
        "value": round(1.0 / s64, 3),
        "how": "1 / cold Jacobi-CG BE-step solve at rtol 1e-6"
               + ("" if conv else " (capped — lower bound)"),
    }
    print("[iterative] heat3d 128^3 BE step", flush=True)
    A, b, _ = heat_system((128,) * 3, (1.0, 1.0, 1.0), 0.01)
    s128, conv = _time_jacobi_cg(A, b, label="128^3 BE step")
    RESULTS["heat3d_128cubed_iterative_steps_per_s"] = {
        "value": round(1.0 / s128, 4),
        "how": "1 / cold Jacobi-CG BE-step solve at rtol 1e-6"
               + ("" if conv else " (capped — lower bound)"),
    }
    print("[iterative] elast3d 2M DOF static (cap 900s)", flush=True)
    A, b, _ = elasticity_system((160, 64, 64), (1.0, 0.2, 0.2), 210e9, 0.3,
                                "3d", [0.0, 0.0, -9.81 * 7800.0])
    s3d, conv = _time_jacobi_cg(A, b, cap_s=900.0, label="2M-DOF cantilever")
    RESULTS["elast3d_2M_iterative_solve_s"] = {
        "value": round(s3d, 1),
        "how": "cold Jacobi-CG at rtol 1e-6"
               + ("" if conv else " (capped — lower bound)"),
    }


def main():
    only = sys.argv[1] if len(sys.argv) > 1 else None
    benches = {
        "1": bench_config1_heat1d, "2": bench_config2_bar1d,
        "3": bench_config3_heat2d, "4": bench_config4_elast2d,
        "5": bench_config5_elast3d, "heat3d": bench_heat3d_secondary,
        "iterative": bench_iterative,
    }
    t0 = time.perf_counter()
    for name, fn in benches.items():
        if only and name != only:
            continue
        fn()
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "reference_baseline.json")
    existing = {}
    if only and os.path.exists(out):
        with open(out) as f:
            existing = json.load(f)
    existing.update(RESULTS)
    with open(out, "w") as f:
        json.dump(existing, f, indent=1)
    print(f"\nwrote {out} ({time.perf_counter() - t0:.0f} s total)")
    for k, v in existing.items():
        if isinstance(v, dict) and "value" in v:
            print(f"| {k} | {v['value']} | {v['how']} |")


if __name__ == "__main__":
    main()
