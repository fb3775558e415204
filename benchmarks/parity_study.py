"""FEniCS-parity evidence for the five BASELINE.md configs (offline).

Real DOLFIN cannot run in this image (no conda/FEniCS, no installs), so the
study uses the two strongest offline checks and RECORDS the numbers:

1. **Surrogate agreement** — relative L2 between this framework's solution
   and ``tests/reference_fem.py``: an independent per-element scipy-sparse
   FEM implementation of the *same* discretization DOLFIN uses (same
   simplicial topology, P1 elements, quadrature, Dirichlet elimination,
   direct solve).  Two independent implementations of the same discrete
   problem agreeing to ~1e-12 bounds the distance to FEniCS by solver
   tolerance, since FEniCS solves the identical discrete system.
2. **Closed-form convergence** — relative L2 against exact solutions with
   mesh refinement, confirming the discretization itself (O(h²) where the
   exact solution is outside the P1 space, exact-to-roundoff where inside).

Run from /root/repo (CPU, float64):  python benchmarks/parity_study.py
Prints a markdown table for PARITY.md.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import scipy.sparse as sp
import scipy.sparse.linalg as spla


def rel_l2(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


ROWS = []


def record(config, case, n_dofs, err, note):
    ROWS.append((config, case, n_dofs, err, note))
    print(f"  [{config}] {case}: DOF={n_dofs} relL2={err:.3e} ({note})",
          file=sys.stderr, flush=True)


# ----------------------------------------------------------------------
def config1_heat1d():
    """1D heat, 2 m rod, 256 nodes, 20→0 °C, backward Euler to steady."""
    import reference_fem as ref
    from pde_solver import api
    from pde_solver.fields import load_field

    nx = 255  # 256 nodes
    res = api.solve_heat_1D(length=2.0, nx=nx, T_left=20.0, T_right=0.0,
                            T_initial=0.0, dt=0.05, num_steps=400,
                            data_dir="data")
    f = load_field(res.data_file)
    ours = f.values_array()[-1]
    x = f.coords_array()[:, 0]

    # surrogate: same BE stepping with scipy splu on the same mesh
    verts, cells = ref.build_simplices((nx,), (0.0,), (2.0,))
    K = ref.assemble(verts, cells, "stiffness")
    M = ref.assemble(verts, cells, "mass")
    order = np.argsort(verts[:, 0])
    n = len(verts)
    dirich = np.zeros(n, bool)
    dirich[np.argmin(verts[:, 0])] = True
    dirich[np.argmax(verts[:, 0])] = True
    g = np.zeros(n)
    g[np.argmin(verts[:, 0])] = 20.0
    free = ~dirich
    dt = 0.05
    A = (M + dt * K).tocsc()
    Aff = A[free][:, free]
    lu = spla.splu(Aff)
    u = g.copy()  # T_initial=0 interior, BC applied
    for _ in range(400):
        b = M @ u
        rhs = b[free] - A[free][:, dirich] @ g[dirich]
        u[free] = lu.solve(rhs)
    sur = u[order]
    record(1, "vs scipy surrogate (same mesh, BE×400)", n, rel_l2(ours, sur),
           "identical discretization")
    exact = 20.0 * (1.0 - x / 2.0)
    record(1, "steady limit vs closed form 20(1−x/L)", n,
           rel_l2(ours, exact), "P1 nodally exact in 1D")


def config2_bar1d():
    """1D elasticity: 2 m aluminum bar, fixed-free, static."""
    from pde_solver.models.elasticity import solve_bar_1d

    E, A_, f = 70e9, 0.01, 500.0
    L = 2.0
    for nx in (255, 511):
        x, field, info = solve_bar_1d(L, nx, E, A_, f, quantity="stress")
        exact = f * (L - x) / A_
        # interior comparison: the P1 projection of the piecewise-constant
        # stress has O(h) endpoint artifacts (FEniCS project shows the same)
        err = rel_l2(field[1:-1], exact[1:-1])
        record(2, f"stress vs closed form f(L−x)/A, nx={nx}", nx + 1, err,
               "projected P1 stress, interior nodes")
    # displacement-level surrogate agreement
    import reference_fem as ref
    nx = 255
    verts, cells = ref.build_simplices((nx,), (0.0,), (L,))
    K = (E * A_) * ref.assemble(verts, cells, "stiffness")
    b = f * ref.assemble_load(verts, cells, degree=1)
    left = int(np.argmin(verts[:, 0]))
    n = len(verts)
    free = np.ones(n, bool)
    free[left] = False
    u = np.zeros(n)
    u[free] = spla.spsolve(K.tocsc()[free][:, free], b[free])
    order = np.argsort(verts[:, 0])
    from pde_solver.mesh import interval_mesh
    from pde_solver.ops import assembly
    from pde_solver.ops.bc import DirichletBC
    from pde_solver.ops.linsolve import solve_stencil_system
    mesh = interval_mesh(nx, 0.0, L)
    K2 = assembly.assemble_scalar_stencil(mesh, "stiffness")
    K2 = {o: (E * A_) * W for o, W in K2.items()}
    b2 = f * assembly.assemble_load(mesh, quad_degree=1)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)], mesh.node_shape)
    ours, _ = solve_stencil_system(K2, mesh, bc, b2)
    record(2, "displacement vs scipy surrogate (same mesh)", n,
           rel_l2(ours, u[order]), "identical discretization")


def config3_heat2d_cn():
    """2D heat 1×1 plate, 128² mesh, 0 °C boundary, 20 °C initial, CN."""
    import reference_fem as ref
    from pde_solver.mesh import rectangle_mesh
    from pde_solver.models import heat
    from pde_solver.config import SolverConfig

    nc, dt, steps = 128, 0.001, 20
    mesh = rectangle_mesh(nc, nc, (0.0, 0.0), (1.0, 1.0))
    p = heat.HeatProblem(
        mesh=mesh, diffusivity=1.0,
        bc_builder=lambda m: [(m.boundary_mask(), 0.0)],
        T_initial=20.0, dt=dt, num_steps=steps, theta=0.5)
    _, values, info = heat.solve_heat_problem(
        p, SolverConfig(precision="f64", tol=1e-12))
    ours = values[-1]

    verts, cells = ref.build_simplices((nc, nc), (0.0, 0.0), (1.0, 1.0))
    K = ref.assemble(verts, cells, "stiffness")
    M = ref.assemble(verts, cells, "mass")
    n = len(verts)
    eps = 1e-12
    onb = ((np.abs(verts[:, 0]) < eps) | (np.abs(verts[:, 0] - 1) < eps)
           | (np.abs(verts[:, 1]) < eps) | (np.abs(verts[:, 1] - 1) < eps))
    free = ~onb
    A = (M + 0.5 * dt * K).tocsc()
    B = (M - 0.5 * dt * K).tocsr()
    lu = spla.splu(A[free][:, free])
    u = np.full(n, 20.0)
    u[onb] = 0.0
    for _ in range(steps):
        rhs = (B @ u)[free]
        u[free] = lu.solve(rhs)
        u[onb] = 0.0
    # node ordering: ours is C-order (x slowest); surrogate x fastest
    shape = (nc + 1, nc + 1)
    idx = np.arange(n).reshape(shape[::-1]).T.ravel()  # x-fastest → C order
    record(3, f"Crank–Nicolson {steps}×dt={dt} vs scipy surrogate", n,
           rel_l2(ours, u[idx]), "identical discretization, CN")


def config4_elasticity2d():
    """2D plane-stress 1×1 steel plate, clamped left edge, body load."""
    import reference_fem as ref
    from pde_solver.mesh import rectangle_mesh
    from pde_solver.ops import assembly
    from pde_solver.ops.bc import DirichletBC
    from pde_solver.ops.linsolve import prepare_system, solve_stencil_system
    from pde_solver.models.elasticity import lame_parameters

    nc = 64
    E, nu = 210e9, 0.3
    lam, mu = lame_parameters(E, nu, "plane_stress")
    body = np.array([0.0, -7.65e4])
    mesh = rectangle_mesh(nc, nc, (0.0, 0.0), (1.0, 1.0))
    K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
    b = assembly.assemble_vector_load(mesh, body)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=2)
    ours, _ = solve_stencil_system(K, mesh, bc, b, vdim=2)

    verts, cells = ref.assemble_elasticity.__globals__["build_simplices"](
        (nc, nc), (0.0, 0.0), (1.0, 1.0))
    Ks = ref.assemble_elasticity(verts, cells, lam, mu)
    n = len(verts)
    bs = np.zeros(2 * n)
    Ms = ref.assemble(verts, cells, "mass")
    for c in range(2):
        bs[c::2] = Ms @ np.full(n, body[c])
    clamped = np.abs(verts[:, 0]) < 1e-12
    free = np.ones(2 * n, bool)
    free[0::2] = ~clamped
    free[1::2] = ~clamped
    us = np.zeros(2 * n)
    us[free] = spla.spsolve(Ks.tocsc()[free][:, free], bs[free])
    shape = (nc + 1, nc + 1)
    idx = np.arange(n).reshape(shape[::-1]).T.ravel()
    sur = np.stack([us[0::2][idx], us[1::2][idx]], axis=1)
    record(4, "plane-stress displacement vs scipy surrogate", 2 * n,
           rel_l2(ours.reshape(-1, 2), sur), "identical discretization")


def config5_elasticity3d():
    """3D cantilever with gravity (flagship discretization, surrogate-size
    mesh — the 2M-DOF perf run is bench.py's job, accuracy is checked here
    where a direct sparse solve is feasible on the 1-core host)."""
    import reference_fem as ref
    from pde_solver.mesh import box_mesh
    from pde_solver.ops import assembly
    from pde_solver.ops.bc import DirichletBC
    from pde_solver.ops.linsolve import solve_stencil_system
    from pde_solver.models.elasticity import lame_parameters

    cells = (16, 8, 8)
    E, nu = 210e9, 0.3
    lam, mu = lame_parameters(E, nu, "3d")
    body = np.array([0.0, 0.0, -9.81 * 7800.0])
    mesh = box_mesh(*cells, (0, 0, 0), (1.0, 0.2, 0.2))
    K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
    b = assembly.assemble_vector_load(mesh, body)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=3)
    ours, stats = solve_stencil_system(K, mesh, bc, b, vdim=3)

    verts, tets = ref.build_simplices(cells, (0.0, 0.0, 0.0), (1.0, 0.2, 0.2))
    Ks = ref.assemble_elasticity(verts, tets, lam, mu)
    n = len(verts)
    Ms = ref.assemble(verts, tets, "mass")
    bs = np.zeros(3 * n)
    for c in range(3):
        bs[c::3] = Ms @ np.full(n, body[c])
    clamped = np.abs(verts[:, 0]) < 1e-12
    free = np.ones(3 * n, bool)
    for c in range(3):
        free[c::3] = ~clamped
    us = np.zeros(3 * n)
    us[free] = spla.spsolve(Ks.tocsc()[free][:, free], bs[free])
    shape = tuple(c + 1 for c in cells)
    idx = np.arange(n).reshape(shape[::-1]).T.ravel()
    sur = np.stack([us[c::3][idx] for c in range(3)], axis=1)
    record(5, f"3D cantilever displacement vs scipy surrogate {cells}",
           3 * n, rel_l2(ours.reshape(-1, 3), sur),
           "identical discretization, direct-solve reference")


def main():
    t0 = time.perf_counter()
    for fn in (config1_heat1d, config2_bar1d, config3_heat2d_cn,
               config4_elasticity2d, config5_elasticity3d):
        t = time.perf_counter()
        fn()
        print(f"  ({fn.__name__}: {time.perf_counter() - t:.1f}s)",
              file=sys.stderr, flush=True)
    print(f"total {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    print("\n| # | Case | DOF | rel. L2 | Notes |")
    print("|---|------|-----|---------|-------|")
    for config, case, n, err, note in ROWS:
        print(f"| {config} | {case} | {n} | {err:.2e} | {note} |")


if __name__ == "__main__":
    main()
