"""Model-level validation: analytic solutions + exact parity vs the
independent scipy FEM reference running the identical discrete scheme.

The scipy path (tests/reference_fem.py + scipy.sparse.linalg.splu) plays the
role of the FEniCS golden files from SURVEY.md §4: same P1 discretization on
the same DOLFIN-compatible meshes, solved with a direct factorization.
Agreement to ~1e-9 relative L2 demonstrates the ≤1e-6 parity target holds by
construction.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import reference_fem as ref
from pde_solver.mesh import interval_mesh, rectangle_mesh, box_mesh
from pde_solver.models import heat
from pde_solver.models.elasticity import solve_bar_1d, solve_elasticity_nd, lame_parameters


def rel_l2(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


# ----------------------------------------------------------------------
# scipy golden-path helpers
# ----------------------------------------------------------------------

def scipy_heat(mesh, weight, kappa, bc_flat_mask, bc_flat_vals, source_value,
               steady, u0_flat=None, dt=None, num_steps=0, cell_coeff=None,
               degree=4):
    """Direct-solver golden path: same scheme, explicit sparse matrices."""
    verts, cells = ref.build_simplices(mesh.n_cells, mesh.origin, mesh.extent)
    K = ref.assemble(verts, cells, "stiffness", weight=weight,
                     cell_coeff=cell_coeff, degree=degree)
    if cell_coeff is None:
        K = kappa * K
    b = source_value * ref.assemble_load(verts, cells, weight=weight, degree=degree)
    free = ~bc_flat_mask
    g = np.where(bc_flat_mask, bc_flat_vals, 0.0)

    def constrained_solve(A, rhs):
        rhs_t = np.where(free, rhs - A @ g, g)
        A = A.tolil()
        A[bc_flat_mask, :] = 0.0
        A[:, bc_flat_mask] = 0.0
        A[bc_flat_mask, bc_flat_mask] = 1.0
        return spla.spsolve(A.tocsr(), rhs_t)

    if steady:
        return constrained_solve(K.copy(), b)
    M = ref.assemble(verts, cells, "mass", weight=weight, degree=degree)
    A = (M + dt * K).tocsr()
    rhs_mask = free
    At = A.tolil()
    At[bc_flat_mask, :] = 0.0
    At[:, bc_flat_mask] = 0.0
    At[bc_flat_mask, bc_flat_mask] = 1.0
    lu = spla.splu(At.tocsr().tocsc())
    Ag = A @ g
    u = u0_flat.copy()
    snaps = [u.copy()]
    for _ in range(num_steps):
        rhs = M @ u + dt * b
        rhs_t = np.where(rhs_mask, rhs - Ag, g)
        u = lu.solve(rhs_t)
        snaps.append(u.copy())
    return np.stack(snaps)


def flat_mask(mesh, pairs):
    """(mask, values) flattened to lexicographic x-fastest order."""
    from pde_solver.mesh import flatten_values
    m = np.zeros(mesh.node_shape, dtype=bool)
    v = np.zeros(mesh.node_shape)
    for mask, val in pairs:
        m |= mask
        v = np.where(mask, val, v)
    return flatten_values(m, mesh.dim), flatten_values(v, mesh.dim)


# ----------------------------------------------------------------------
# Heat: analytic steady profiles
# ----------------------------------------------------------------------

def test_heat_1d_steady_linear_profile():
    mesh = interval_mesh(256, 0.0, 2.0)
    p = heat.HeatProblem(mesh=mesh, steady=True,
                         bc_pairs=[(mesh.face_mask(0, 0), 20.0),
                                   (mesh.face_mask(0, 1), 0.0)])
    _, values, info = heat.solve_heat_problem(p)
    exact = 20.0 * (1 - mesh.axis_nodes(0) / 2.0)
    assert info["converged"]
    assert np.max(np.abs(values[0] - exact)) < 1e-8


def test_heat_1d_cylindrical_steady_log_profile():
    mesh = interval_mesh(400, 0.5, 2.0)
    p = heat.HeatProblem(mesh=mesh, steady=True, weight_fn=heat.weight_r,
                         weight_quad_degree=3,
                         bc_pairs=[(mesh.face_mask(0, 0), 100.0),
                                   (mesh.face_mask(0, 1), 20.0)])
    _, values, info = heat.solve_heat_problem(p)
    r = mesh.axis_nodes(0)
    exact = 100.0 + (20.0 - 100.0) * np.log(r / 0.5) / np.log(2.0 / 0.5)
    assert rel_l2(values[0], exact) < 2e-6  # O(h²) discretization


def test_heat_1d_spherical_steady_1_over_r_profile():
    mesh = interval_mesh(400, 0.5, 2.0)
    p = heat.HeatProblem(mesh=mesh, steady=True, weight_fn=heat.weight_r2,
                         weight_quad_degree=4,
                         bc_pairs=[(mesh.face_mask(0, 0), 100.0),
                                   (mesh.face_mask(0, 1), 20.0)])
    _, values, info = heat.solve_heat_problem(p)
    r = mesh.axis_nodes(0)
    exact = 100.0 + (20.0 - 100.0) * (1 / 0.5 - 1 / r) / (1 / 0.5 - 1 / 2.0)
    assert rel_l2(values[0], exact) < 5e-6  # O(h²) discretization error


# ----------------------------------------------------------------------
# Heat: exact parity vs scipy golden path (steady + transient)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("steady", [True, False], ids=["steady", "transient"])
def test_heat_2d_parity_vs_scipy(steady):
    mesh = rectangle_mesh(12, 10, (0.0, 0.0), (1.0, 1.0))
    pairs = [(mesh.boundary_mask(), 0.0)]
    p = heat.HeatProblem(mesh=mesh, diffusivity=0.7, steady=steady,
                         bc_pairs=pairs, source_type="constant", source_value=5.0,
                         T_initial=20.0, dt=0.01, num_steps=10)
    times, values, info = heat.solve_heat_problem(p)
    fm, fv = flat_mask(mesh, pairs)
    u0 = np.where(fm, fv, 20.0)
    golden = scipy_heat(mesh, None, 0.7, fm, fv, 5.0, steady,
                        u0_flat=u0, dt=0.01, num_steps=10)
    if steady:
        assert rel_l2(values[0], golden) < 1e-9
    else:
        assert values.shape == (11, mesh.num_nodes)
        assert rel_l2(values, golden) < 1e-9
        assert np.allclose(times, 0.01 * np.arange(11))


def test_heat_2d_spherical_parity_vs_scipy():
    mesh = rectangle_mesh(10, 8, (0.2, 0.0), (1.0, np.pi))
    pairs = [(mesh.boundary_mask(), 20.0)]
    p = heat.HeatProblem(mesh=mesh, diffusivity=1.0, steady=False,
                         weight_fn=heat.weight_r2_sin_theta, weight_quad_degree=6,
                         bc_pairs=pairs, source_type="constant", source_value=30.0,
                         T_initial=50.0, curvilinear_ic=True, dt=0.02, num_steps=5)
    times, values, _ = heat.solve_heat_problem(p)
    fm, fv = flat_mask(mesh, pairs)
    u0 = np.where(fm, fv, 50.0)

    def w(x):
        return x[..., 0] ** 2 * np.sin(x[..., 1])

    golden = scipy_heat(mesh, w, 1.0, fm, fv, 30.0, False,
                        u0_flat=u0, dt=0.02, num_steps=5, degree=6)
    assert rel_l2(values, golden) < 1e-9


@pytest.mark.parametrize("weight_kind,tol", [
    ("poly", 1e-9),     # polynomial weight: both quadratures exact → exact parity
    ("sqrt_r", 2e-5),   # √(y²+z²): non-polynomial → quadrature-level agreement
], ids=["poly-exact", "sqrt-quadrature"])
def test_heat_3d_composite_directional_parity_vs_scipy(weight_kind, tol):
    """Cylinder-in-box weighting, composite core, directional BCs —
    the richest reference configuration (fenics_mcp_server.py:475-762)."""
    R = 0.5
    mesh = box_mesh(6, 5, 5, (0.0, -R, -R), (2.0, R, R))
    kappa_cells = heat.composite_kappa_cells(mesh, 0.25, 1.0, 10.0)
    from pde_solver.ops.bc import radius_shell
    pairs = [(mesh.face_mask(0, 0), 80.0), (mesh.face_mask(0, 1), 10.0),
             (radius_shell(mesh, (1, 2), R, exclude_axis_faces=0), 20.0)]

    if weight_kind == "poly":
        def w(x):
            return x[..., 1] ** 2 + x[..., 2] ** 2 + 0.1
    else:
        def w(x):
            return np.sqrt(x[..., 1] ** 2 + x[..., 2] ** 2)

    p = heat.HeatProblem(mesh=mesh, steady=True, weight_fn=w,
                         weight_quad_degree=4, kappa_cells=kappa_cells,
                         bc_pairs=pairs, source_type="constant", source_value=3.0)
    _, values, _ = heat.solve_heat_problem(p)

    # golden: same marking expanded per global cell; reference_fem iterates
    # cells in itertools.product order (x slowest) with 6 sub-simplices
    # innermost:
    fm, fv = flat_mask(mesh, pairs)
    cc = np.moveaxis(kappa_cells, 0, -1).reshape(-1)  # [x,y,z,n_sub] → flat

    golden = scipy_heat(mesh, w, None, fm, fv, 3.0, True, cell_coeff=cc, degree=4)
    assert rel_l2(values[0], golden) < tol


def test_heat_ic_projection_cosine_matches_scipy_projection():
    mesh = interval_mesh(40, 0.0, 2.0)
    p = heat.HeatProblem(mesh=mesh, bc_pairs=[(mesh.face_mask(0, 0), 1.0),
                                              (mesh.face_mask(0, 1), 0.0)],
                         initial_type="cosine", initial_amplitude=2.0,
                         initial_wavenumber=3.0, dt=0.01, num_steps=1)
    times, values, _ = heat.solve_heat_problem(p)
    # golden projection: M p = ∫ 2cos(3x) φ dx, then BCs forced
    verts, cells = ref.build_simplices(mesh.n_cells, mesh.origin, mesh.extent)
    M = ref.assemble(verts, cells, "mass", degree=2)
    b = ref.assemble_load(verts, cells, f=lambda x: 2.0 * np.cos(3.0 * x[..., 0]),
                          degree=4)
    pgold = spla.spsolve(M.tocsr(), b)
    pgold[0], pgold[-1] = 1.0, 0.0
    assert rel_l2(values[0], pgold) < 1e-8


def test_crank_nicolson_second_order_decay():
    """CN (θ=1/2) must be 2nd-order accurate in dt on a decaying mode."""
    L, k = 1.0, 1.0
    errs = []
    for num_steps in (10, 20):
        mesh = interval_mesh(200, 0.0, L)
        p = heat.HeatProblem(mesh=mesh, diffusivity=k, theta=0.5,
                             bc_pairs=[(mesh.face_mask(0, 0), 0.0),
                                       (mesh.face_mask(0, 1), 0.0)],
                             initial_type="sine", initial_amplitude=1.0,
                             initial_wavenumber=np.pi / L,
                             dt=0.1 / num_steps, num_steps=num_steps)
        _, values, _ = heat.solve_heat_problem(p)
        x = mesh.axis_nodes(0)
        exact = np.sin(np.pi * x / L) * np.exp(-k * (np.pi / L) ** 2 * 0.1)
        errs.append(np.max(np.abs(values[-1] - exact)))
    # halving dt should cut the error ~4x (allow slack for spatial error)
    assert errs[1] < errs[0] / 2.5


# ----------------------------------------------------------------------
# Elasticity
# ----------------------------------------------------------------------

def test_bar_1d_analytic_stress():
    L, nx, E, A, f = 2.0, 100, 70e9, 0.01, 500.0
    x, sigma, info = solve_bar_1d(L, nx, E, A, f, "stress")
    exact = f * (L - x) / A
    # The consistent-mass projection of piecewise-constant stress carries a
    # boundary layer decaying ×(2-√3)≈0.27 per node (FEniCS project shows the
    # identical wiggle); interior nodes are exact.
    assert np.max(np.abs(sigma[8:-8] - exact[8:-8])) < 1e-6 * np.max(np.abs(exact))
    assert np.abs(sigma[1] - exact[1]) < 0.1 * np.max(np.abs(exact))
    assert info["converged"]


def test_bar_1d_strain_output():
    L, nx, E, A, f = 1.0, 50, 210e9, 1.0, 1000.0
    x, eps, _ = solve_bar_1d(L, nx, E, A, f, "strain")
    exact = f * (L - x) / (E * A)
    # tolerance limited by CG relres × conditioning on the tiny strain scale
    assert np.max(np.abs(eps[8:-8] - exact[8:-8])) < 1e-6 * max(np.max(np.abs(exact)), 1e-12)


@pytest.mark.parametrize("mode", ["plane_stress", "plane_strain"])
def test_elasticity_2d_parity_vs_scipy(mode):
    mesh = rectangle_mesh(8, 6, (0.0, 0.0), (1.0, 1.0))
    E, nu = 210e9, 0.3
    body = np.array([0.0, -7.65e4])
    vm, info = solve_elasticity_nd(mesh, E, nu, body, mode, "stress")

    # scipy golden: dense vector solve + projection of von Mises
    lam, mu = lame_parameters(E, nu, mode)
    verts, cells = ref.build_simplices(mesh.n_cells, mesh.origin, mesh.extent)
    Kel = ref.assemble_elasticity(verts, cells, lam, mu).tolil()
    d = 2
    N = len(verts)
    b = np.zeros(N * d)
    bload = ref.assemble_load(verts, cells, degree=1)
    for i in range(d):
        b[i::d] = bload * body[i]
    clamped = np.repeat(np.isclose(verts[:, 0], 0.0), d)
    b = np.where(clamped, 0.0, b)
    Kel[clamped, :] = 0.0
    Kel[:, clamped] = 0.0
    Kel[clamped, clamped] = 1.0
    u = spla.spsolve(Kel.tocsr(), b)
    # per-element von Mises
    rows_v = []
    Mmat = ref.assemble(verts, cells, "mass", degree=2)
    rhs = np.zeros(N)
    for cell in cells:
        X = verts[cell]
        J = (X[1:] - X[0]).T
        grads = np.vstack([-np.ones((1, d)), np.eye(d)]) @ np.linalg.inv(J)
        G = np.zeros((d, d))
        for a in range(d + 1):
            G += np.outer(u[cell[a] * d: cell[a] * d + d], grads[a])
        eps = 0.5 * (G + G.T)
        sig = lam * np.trace(eps) * np.eye(d) + 2 * mu * eps
        sdev = sig - np.trace(sig) / 3.0 * np.eye(d)
        vmval = np.sqrt(1.5 * np.sum(sdev * sdev))
        vol = abs(np.linalg.det(J)) / 2.0
        for a in range(d + 1):
            rhs[cell[a]] += vmval * vol / (d + 1)
    vm_gold = spla.spsolve(Mmat.tocsr(), rhs)
    assert rel_l2(vm, vm_gold) < 1e-8


def test_elasticity_3d_parity_vs_scipy():
    mesh = box_mesh(4, 3, 3, (0, 0, 0), (1.0, 0.2, 0.2))
    E, nu = 210e9, 0.3
    body = np.array([0.0, 0.0, -7.65e4])
    vm, info = solve_elasticity_nd(mesh, E, nu, body, "3d", "stress")
    lam, mu = lame_parameters(E, nu, "3d")
    verts, cells = ref.build_simplices(mesh.n_cells, mesh.origin, mesh.extent)
    Kel = ref.assemble_elasticity(verts, cells, lam, mu).tolil()
    d, N = 3, len(verts)
    b = np.zeros(N * d)
    bload = ref.assemble_load(verts, cells, degree=1)
    for i in range(d):
        b[i::d] = bload * body[i]
    clamped = np.repeat(np.isclose(verts[:, 0], 0.0), d)
    b = np.where(clamped, 0.0, b)
    Kel[clamped, :] = 0.0
    Kel[:, clamped] = 0.0
    Kel[clamped, clamped] = 1.0
    u = spla.spsolve(Kel.tocsr(), b)
    Mmat = ref.assemble(verts, cells, "mass", degree=2)
    rhs = np.zeros(N)
    import math
    for cell in cells:
        X = verts[cell]
        J = (X[1:] - X[0]).T
        grads = np.vstack([-np.ones((1, d)), np.eye(d)]) @ np.linalg.inv(J)
        G = np.zeros((d, d))
        for a in range(d + 1):
            G += np.outer(u[cell[a] * d: cell[a] * d + d], grads[a])
        eps = 0.5 * (G + G.T)
        sig = lam * np.trace(eps) * np.eye(d) + 2 * mu * eps
        sdev = sig - np.trace(sig) / 3.0 * np.eye(d)
        vmval = np.sqrt(1.5 * np.sum(sdev * sdev))
        vol = abs(np.linalg.det(J)) / math.factorial(d)
        for a in range(d + 1):
            rhs[cell[a]] += vmval * vol / (d + 1)
    vm_gold = spla.spsolve(Mmat.tocsr(), rhs)
    assert rel_l2(vm, vm_gold) < 1e-7


def test_composite_core_multigrid_matches_plain_cg():
    """Composite-coefficient steady heat now runs geometric MG (the
    kappa_builder re-marks the core per level, VERDICT r1 item 6); the MG
    route must agree with the plain-CG route to solver tolerance."""
    from pde_solver.config import SolverConfig

    mesh = box_mesh(16, 16, 16, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))

    def kb(m):
        return heat.composite_kappa_cells(m, 0.3, 1.0, 50.0,
                                          radial_axes=(1, 2))

    def make(use_mg):
        return heat.HeatProblem(
            mesh=mesh, diffusivity=1.0,
            kappa_builder=kb if use_mg else None,
            kappa_cells=None if use_mg else kb(mesh),
            bc_builder=lambda m: [(m.face_mask(0, 0), 100.0),
                                  (m.face_mask(0, 1), 0.0)],
            steady=True)

    cfg_mg = SolverConfig(precision="f64", use_multigrid=True, mg_threshold=100)
    _, v_mg, info_mg = heat.solve_heat_problem(make(True), cfg_mg)
    cfg_cg = SolverConfig(precision="f64", use_multigrid=False)
    _, v_cg, info_cg = heat.solve_heat_problem(make(False), cfg_cg)
    assert info_mg["converged"] and info_cg["converged"]
    scale = np.abs(v_cg).max()
    assert np.abs(v_mg - v_cg).max() < 1e-7 * scale
    # MG must actually help: far fewer iterations than plain CG
    assert info_mg["cg_iterations"] < info_cg["cg_iterations"]


def test_device_von_mises_matches_host():
    """The f32 device von Mises path (used for big accelerator solves) must match
    the exact f64 host path to f32 accuracy, 2D and 3D."""
    from pde_solver.models import elasticity as el

    rng = np.random.default_rng(3)
    for mesh, d in ((rectangle_mesh(9, 7, (0, 0), (1.0, 0.7)), 2),
                    (box_mesh(6, 5, 4, (0, 0, 0), (1.0, 0.8, 0.6)), 3)):
        u = 1e-3 * rng.standard_normal(mesh.node_shape + (d,))
        lam, mu = lame_parameters(210e9, 0.3, "3d" if d == 3 else "plane_strain")
        s_h, e_h = el._vm_from_gradients(
            el._element_gradients(mesh, u), np, d, lam, mu)
        s_d, e_d = el._von_mises_device(mesh, u, lam, mu)
        np.testing.assert_allclose(s_d, s_h, rtol=2e-6,
                                   atol=2e-6 * float(np.max(s_h)))
        np.testing.assert_allclose(e_d, e_h, rtol=2e-6,
                                   atol=2e-6 * float(np.max(e_h)))


def test_transient_info_timing_contract():
    """scan_seconds measures stepping only; the trajectory device->host
    retrieval is reported separately as fetch_seconds."""
    mesh = rectangle_mesh(8, 8, (0.0, 0.0), (1.0, 1.0))
    p = heat.HeatProblem(mesh=mesh, diffusivity=1.0,
                         bc_pairs=[(mesh.boundary_mask(), 0.0)],
                         T_initial=20.0, dt=0.01, num_steps=4)
    _, values, info = heat.solve_heat_problem(p)
    assert values.shape[0] == 5
    for key in ("scan_seconds", "setup_seconds", "fetch_seconds"):
        assert key in info and info[key] >= 0.0
