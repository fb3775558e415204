"""Robin (convective) and Neumann (flux) boundary conditions.

Beyond-reference capability (the reference heat solvers are Dirichlet-only,
fenics_mcp_server.py:294-297): validated against closed-form solutions —
P1 FEM reproduces linear profiles exactly, so the 1D/2D/3D mixed
Dirichlet+Robin steady states must match at machine precision — plus dense
symmetry/SPD checks and a dense backward-Euler transient parity run.
"""

import numpy as np
import pytest

from pde_solver.mesh import box_mesh, interval_mesh, rectangle_mesh
from pde_solver.models import heat
from pde_solver.models.heat import HeatProblem
from pde_solver.ops import assembly, surface


# ----------------------------------------------------------------------
# Surface assembly primitives
# ----------------------------------------------------------------------

def test_face_load_sums_to_face_area():
    mesh = box_mesh(4, 5, 6, (0, 0, 0), (2.0, 3.0, 1.5))
    # ∫_Γ Σ_n φ_n ds = |Γ| since Σ φ_n ≡ 1
    areas = {0: 3.0 * 1.5, 1: 2.0 * 1.5, 2: 2.0 * 3.0}
    for axis in range(3):
        for side in (0, 1):
            b = surface.assemble_face_load(mesh, axis, side)
            assert np.isclose(b.sum(), areas[axis], rtol=1e-12)
            # support confined to the face plane
            idx = [slice(None)] * 3
            idx[axis] = slice(1, -1)
            assert np.all(b[tuple(idx)] == 0.0)


def test_face_mass_row_sums_match_face_load():
    # Σ_m A[n,m] = ∫_Γ φ_n ds row sums (partition of unity on the face)
    mesh = rectangle_mesh(5, 7, (0, 0), (1.0, 2.0))
    for axis in range(2):
        for side in (0, 1):
            st = surface.assemble_face_mass(mesh, axis, side, coeff=3.0)
            rows = sum(W for W in st.values()) * 0.0
            for off, W in st.items():
                # row sum: shift columns back onto rows
                src = tuple(slice(max(0, -o), W.shape[a] - max(0, o))
                            for a, o in enumerate(off))
                rows[src] += W[src]
            b = 3.0 * surface.assemble_face_load(mesh, axis, side)
            np.testing.assert_allclose(rows, b, rtol=1e-12, atol=1e-14)


def test_face_mass_symmetric_spd_dense():
    mesh = box_mesh(3, 3, 3, (0, 0, 0), (1.0, 1.0, 1.0))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    for axis, side, h in [(0, 1, 5.0), (2, 0, 2.0)]:
        K = surface.add_stencil(
            K, surface.assemble_face_mass(mesh, axis, side, coeff=h))
    A = assembly.stencil_to_dense(mesh, K)
    np.testing.assert_allclose(A, A.T, atol=1e-13)
    # pure-Neumann stiffness is singular; the Robin mass must lift it to SPD
    w = np.linalg.eigvalsh(A)
    assert w.min() > 1e-10


# ----------------------------------------------------------------------
# Closed-form steady states (linear profiles: exact for P1)
# ----------------------------------------------------------------------

def _linear_dirichlet_robin(kappa, L, T0, h, t_inf):
    """u(x) = T0 + c x / kappa with -kappa u'(L) = h (u(L) - t_inf)."""
    c = h * (t_inf - T0) / (1.0 + h * L / kappa)
    return lambda x: T0 + c * x / kappa


def test_1d_dirichlet_robin_exact():
    kappa, L, T0, h, t_inf = 2.5, 3.0, 100.0, 7.0, 25.0
    mesh = interval_mesh(32, 0.0, L)
    p = HeatProblem(mesh=mesh, diffusivity=kappa, steady=True,
                    bc_pairs=[(mesh.face_mask(0, 0), T0)],
                    robin_faces=[(0, 1, h, t_inf)])
    _, values, info = heat.solve_heat_problem(p)
    u_exact = _linear_dirichlet_robin(kappa, L, T0, h, t_inf)
    x = mesh.flat_node_coords()[:, 0]
    np.testing.assert_allclose(values[0], u_exact(x), rtol=1e-8)
    assert info["converged"]


def test_1d_dirichlet_flux_exact():
    kappa, L, q = 4.0, 2.0, 50.0  # u = q x / kappa
    mesh = interval_mesh(16, 0.0, L)
    p = HeatProblem(mesh=mesh, diffusivity=kappa, steady=True,
                    bc_pairs=[(mesh.face_mask(0, 0), 0.0)],
                    flux_faces=[(0, 1, q)])
    _, values, _ = heat.solve_heat_problem(p)
    x = mesh.flat_node_coords()[:, 0]
    np.testing.assert_allclose(values[0], q * x / kappa,
                               rtol=1e-8, atol=1e-10)


def test_1d_pure_robin_no_dirichlet():
    # both ends convective, no Dirichlet constraint anywhere: the Robin
    # surface mass alone must regularize the singular Neumann operator
    kappa, L = 1.5, 2.0
    hl, tl, hr, tr = 3.0, 80.0, 6.0, 20.0
    # u = a + c x:  kappa c = hl (a - tl);  -kappa c = hr (a + c L - tr)
    Amat = np.array([[hl, -kappa], [hr, kappa + hr * L]])
    rhs = np.array([hl * tl, hr * tr])
    a, c = np.linalg.solve(Amat, rhs)
    mesh = interval_mesh(24, 0.0, L)
    p = HeatProblem(mesh=mesh, diffusivity=kappa, steady=True,
                    robin_faces=[(0, 0, hl, tl), (0, 1, hr, tr)])
    _, values, info = heat.solve_heat_problem(p)
    x = mesh.flat_node_coords()[:, 0]
    np.testing.assert_allclose(values[0], a + c * x, rtol=1e-7)
    assert info["converged"]


@pytest.mark.parametrize("dim", [2, 3])
def test_nd_dirichlet_robin_insulated_sides(dim):
    # left face Dirichlet, right face Robin, all other faces natural
    # (insulated) → the exact solution is the 1D linear profile in x,
    # which P1 reproduces exactly; validates the face-mass scatter in 2D/3D
    kappa, L, T0, h, t_inf = 1.2, 2.0, 60.0, 4.0, 10.0
    if dim == 2:
        mesh = rectangle_mesh(12, 7, (0, 0), (L, 1.3))
    else:
        mesh = box_mesh(10, 5, 6, (0, 0, 0), (L, 0.8, 1.1))
    p = HeatProblem(mesh=mesh, diffusivity=kappa, steady=True,
                    bc_pairs=[(mesh.face_mask(0, 0), T0)],
                    robin_faces=[(0, 1, h, t_inf)])
    _, values, info = heat.solve_heat_problem(p)
    u_exact = _linear_dirichlet_robin(kappa, L, T0, h, t_inf)
    x = mesh.flat_node_coords()[:, 0]
    np.testing.assert_allclose(values[0], u_exact(x), rtol=1e-7)
    assert info["converged"]


def test_3d_flux_plus_robin_combination():
    # inward flux at x=0, convection at x=L: c = -q_in (steady flux balance),
    # u(x) = u(L) + q_in (L - x)/kappa with u(L) = t_inf + q_in / h
    kappa, L, q_in, h, t_inf = 2.0, 1.5, 30.0, 5.0, 40.0
    mesh = box_mesh(8, 4, 4, (0, 0, 0), (L, 1.0, 1.0))
    p = HeatProblem(mesh=mesh, diffusivity=kappa, steady=True,
                    flux_faces=[(0, 0, q_in)],
                    robin_faces=[(0, 1, h, t_inf)])
    _, values, info = heat.solve_heat_problem(p)
    uL = t_inf + q_in / h
    x = mesh.flat_node_coords()[:, 0]
    np.testing.assert_allclose(values[0], uL + q_in * (L - x) / kappa,
                               rtol=1e-7)
    assert info["converged"]


def test_1d_cylindrical_robin_weighted():
    # annulus r in [r1, r2], Dirichlet at r1, convection at r2, weight w=r:
    # u = A + B ln r with A + B ln r1 = T0 and -kappa B / r2 = h (u(r2)-t_inf)
    kappa, r1, r2, T0, h, t_inf = 1.0, 0.5, 2.0, 100.0, 3.0, 20.0
    M = np.array([[1.0, np.log(r1)],
                  [h, h * np.log(r2) + kappa / r2]])
    A, B = np.linalg.solve(M, np.array([T0, h * t_inf]))
    mesh = interval_mesh(512, r1, r2)
    p = HeatProblem(mesh=mesh, diffusivity=kappa, steady=True,
                    weight_fn=heat.weight_r,
                    bc_pairs=[(mesh.face_mask(0, 0), T0)],
                    robin_faces=[(0, 1, h, t_inf)])
    _, values, _ = heat.solve_heat_problem(p)
    r = mesh.flat_node_coords()[:, 0]
    np.testing.assert_allclose(values[0], A + B * np.log(r), rtol=2e-5)


# ----------------------------------------------------------------------
# Transient parity vs dense stepping
# ----------------------------------------------------------------------

def test_transient_robin_matches_dense_backward_euler():
    mesh = rectangle_mesh(6, 5, (0, 0), (1.0, 1.0))
    h, t_inf, kappa, dt, nsteps = 8.0, 25.0, 1.0, 0.02, 12
    robin = [(0, 0, h, t_inf), (0, 1, h, t_inf),
             (1, 0, h, t_inf), (1, 1, h, t_inf)]
    p = HeatProblem(mesh=mesh, diffusivity=kappa, T_initial=90.0,
                    dt=dt, num_steps=nsteps, theta=1.0,
                    robin_faces=robin)
    times, values, info = heat.solve_heat_problem(p)

    # independent dense BE: (M + dt A) u+ = M u + dt b
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    b = np.zeros(mesh.node_shape)
    for axis, side, hh, tt in robin:
        K = surface.add_stencil(
            K, surface.assemble_face_mass(mesh, axis, side, coeff=hh))
        b += surface.assemble_face_load(mesh, axis, side, coeff=hh * tt)
    A = assembly.stencil_to_dense(mesh, K)
    M = assembly.stencil_to_dense(
        mesh, assembly.assemble_scalar_stencil(mesh, "mass"))
    from pde_solver.mesh import flatten_values
    u = np.full(mesh.num_nodes, 90.0)
    bf = flatten_values(b, 2)
    lhs = M + dt * A
    for n in range(nsteps):
        u = np.linalg.solve(lhs, M @ u + dt * bf)
    np.testing.assert_allclose(values[-1], u, rtol=1e-5, atol=1e-6)
    # convective cooling must pull the block toward ambient monotonically
    means = values.mean(axis=1)
    assert np.all(np.diff(means) < 0) and means[-1] > t_inf


# ----------------------------------------------------------------------
# Radial (curvilinear) mixed tool
# ----------------------------------------------------------------------

def test_radial_mixed_sphere_dirichlet_robin_analytic():
    from pde_solver import api
    from pde_solver.fields import load_field
    kappa, r1, r2, T0, h, t_inf = 2.0, 0.5, 1.5, 300.0, 8.0, 20.0
    # u = A + B/r:  A + B/r1 = T0;  kappa B / r2^2 = h (A + B/r2 - t_inf)
    M = np.array([[1.0, 1.0 / r1],
                  [h, h / r2 - kappa / r2 ** 2]])
    A, B = np.linalg.solve(M, np.array([T0, h * t_inf]))
    res = api.solve_heat_radial_mixed(
        kind="sphere", r_inner=r1, r_outer=r2, nr=400, diffusivity=kappa,
        steady=True,
        boundary_conditions={
            "inner": T0,
            "outer": {"type": "robin", "h": h, "T_ambient": t_inf}})
    f = load_field(res.data_file)
    r = f.coords_array()[:, 0]
    np.testing.assert_allclose(f.values_array()[0], A + B / r, rtol=2e-5)
    assert f.meta["geometry_type"] == "shell"


def test_radial_mixed_solid_cylinder_quench_transient():
    from pde_solver import api
    from pde_solver.fields import load_field
    res = api.solve_heat_radial_mixed(
        kind="cylinder", r_inner=0.0, r_outer=1.0, nr=64, diffusivity=1.0,
        T_initial=400.0, dt=0.02, num_steps=10,
        boundary_conditions={"all": {"type": "robin", "h": 25.0,
                                     "T_ambient": 20.0}})
    f = load_field(res.data_file)
    v = f.values_array()
    # convective cooling: monotone decay toward the bath, surface coolest
    means = v.mean(axis=1)
    assert np.all(np.diff(means) < 0) and v[-1].min() > 20.0
    assert v[-1][-1] < v[-1][0]  # outer surface cools first (r ascending)
    # solid body: the r=0 axis needs no BC and must stay regular/finite
    assert np.all(np.isfinite(v))


def test_sharded_solve_composes_with_robin():
    """Robin surface terms ride the same stencil representation, so the
    domain-decomposed (shard_devices>1) solve must produce the identical
    closed-form Dirichlet+Robin profile."""
    import jax
    import pytest as _pytest
    if len(jax.devices()) < 8:
        _pytest.skip("needs 8 virtual devices")
    from pde_solver.config import config_overrides

    kappa, L, T0, h, t_inf = 1.2, 2.0, 60.0, 4.0, 10.0
    mesh = rectangle_mesh(13, 6, (0, 0), (L, 1.0))  # 14 x-planes / 8 dev
    p = HeatProblem(mesh=mesh, diffusivity=kappa, steady=True,
                    bc_pairs=[(mesh.face_mask(0, 0), T0)],
                    robin_faces=[(0, 1, h, t_inf)])
    with config_overrides(shard_devices=8):
        _, values, info = heat.solve_heat_problem(p)
    u_exact = _linear_dirichlet_robin(kappa, L, T0, h, t_inf)
    x = mesh.flat_node_coords()[:, 0]
    np.testing.assert_allclose(values[0], u_exact(x), rtol=1e-7)
    assert info["converged"]
