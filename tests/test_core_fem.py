"""Core FEM validation: stencil assembly vs an independent textbook FEM.

Agreement between the vectorized stencil assembly and the per-element scipy
reference (tests/reference_fem.py) on identical DOLFIN-compatible meshes
validates both the math and the topology — the FEniCS-parity surrogate
(SURVEY.md §4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from pde_solver.mesh import StructuredMesh, interval_mesh, rectangle_mesh, box_mesh
from pde_solver.ops import assembly
from pde_solver.ops.stencil import StencilOperator
from pde_solver.ops.bc import DirichletBC, all_boundary, face
from pde_solver.ops.cg import pcg, solve_refined

import reference_fem as ref


MESHES = [
    interval_mesh(7, 0.0, 2.0),
    rectangle_mesh(4, 3, (0.0, 0.0), (1.5, 1.0)),
    box_mesh(3, 2, 2, (0.0, 0.0, 0.0), (1.0, 0.8, 0.6)),
]


def _dense_pair(mesh, term, weight=None, degree=4):
    st = assembly.assemble_scalar_stencil(mesh, term, weight_fn=weight, quad_degree=degree)
    A = assembly.stencil_to_dense(mesh, st)
    verts, cells = ref.build_simplices(mesh.n_cells, mesh.origin, mesh.extent)
    B = ref.assemble(verts, cells, term=term, weight=weight, degree=degree).toarray()
    return A, B, verts


@pytest.mark.parametrize("mesh", MESHES, ids=["1d", "2d", "3d"])
@pytest.mark.parametrize("term", ["stiffness", "mass"])
def test_unweighted_matrices_match_reference(mesh, term):
    A, B, _ = _dense_pair(mesh, term)
    assert np.allclose(A, B, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("mesh", MESHES, ids=["1d", "2d", "3d"])
def test_weighted_matrices_match_reference(mesh):
    def weight(x):  # r-style linear weight in the first coordinate + offset
        return x[..., 0] + 0.5

    for term in ("stiffness", "mass"):
        A, B, _ = _dense_pair(mesh, term, weight=weight, degree=4)
        assert np.allclose(A, B, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("mesh", MESHES, ids=["1d", "2d", "3d"])
def test_load_vector_matches_reference(mesh):
    def weight(x):
        return x[..., 0] ** 2 + 1.0

    b = assembly.assemble_load(mesh, weight_fn=weight, quad_degree=4)
    b_flat = np.moveaxis(b, range(mesh.dim), range(mesh.dim)[::-1]).reshape(-1)
    verts, cells = ref.build_simplices(mesh.n_cells, mesh.origin, mesh.extent)
    b_ref = ref.assemble_load(verts, cells, weight=weight, degree=4)
    assert np.allclose(b_flat, b_ref, rtol=1e-12, atol=1e-14)


def test_stencil_apply_equals_dense():
    mesh = box_mesh(3, 3, 2, (0, 0, 0), (1, 1, 1))
    st = assembly.assemble_scalar_stencil(mesh, "stiffness")
    A = assembly.stencil_to_dense(mesh, st)
    op = StencilOperator.from_numpy(st, mesh.node_shape, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    x_grid = rng.standard_normal(mesh.node_shape)
    y = np.asarray(op.apply(jnp.asarray(x_grid)))
    x_flat = np.moveaxis(x_grid, range(3), range(3)[::-1]).reshape(-1)
    y_flat = np.moveaxis(y, range(3), range(3)[::-1]).reshape(-1)
    assert np.allclose(y_flat, A @ x_flat, rtol=1e-12, atol=1e-12)


def test_elasticity_stencil_matches_reference():
    mesh = box_mesh(2, 2, 2, (0, 0, 0), (1.0, 0.7, 0.9))
    lam, mu = 1.3, 0.7
    st = assembly.assemble_elasticity_stencil(mesh, lam, mu)
    A = assembly.stencil_to_dense(mesh, st, vdim=3)
    verts, cells = ref.build_simplices(mesh.n_cells, mesh.origin, mesh.extent)
    B = ref.assemble_elasticity(verts, cells, lam, mu).toarray()
    assert np.allclose(A, B, rtol=1e-12, atol=1e-12)
    # SPD sanity on the constrained system
    assert np.allclose(A, A.T, atol=1e-12)


def test_pcg_poisson_1d_linear_profile():
    """Steady heat: -k u'' = 0, u(0)=20, u(L)=0 → exact linear profile."""
    L, n = 2.0, 64
    mesh = interval_mesh(n, 0.0, L)
    st = assembly.assemble_scalar_stencil(mesh, "stiffness")
    op = StencilOperator.from_numpy(st, mesh.node_shape, dtype=jnp.float64)
    bc = DirichletBC.from_masks(
        [(face(mesh, 0, 0), 20.0), (face(mesh, 0, 1), 0.0)], mesh.node_shape
    )
    apply_c = bc.constrain_operator(op.apply)
    b = bc.constrain_rhs(op.apply, jnp.zeros(mesh.node_shape, jnp.float64))
    inv_diag = 1.0 / op.diagonal()
    x, stats = pcg(apply_c, b, inv_diag=inv_diag, tol=1e-13)
    exact = 20.0 * (1.0 - mesh.axis_nodes(0) / L)
    assert bool(stats.converged)
    assert np.allclose(np.asarray(x), exact, atol=1e-9)


def test_pcg_poisson_3d_vs_dense_solve():
    mesh = box_mesh(4, 3, 3, (0, 0, 0), (1, 1, 1))
    st = assembly.assemble_scalar_stencil(mesh, "stiffness")
    A = assembly.stencil_to_dense(mesh, st)
    op = StencilOperator.from_numpy(st, mesh.node_shape, dtype=jnp.float64)
    bc = DirichletBC.from_masks([(all_boundary(mesh), 5.0)], mesh.node_shape)
    b_np = assembly.assemble_load(mesh) * 3.0  # constant source f=3
    apply_c = bc.constrain_operator(op.apply)
    b = bc.constrain_rhs(op.apply, jnp.asarray(b_np))
    x, stats = pcg(apply_c, b, inv_diag=1.0 / op.diagonal(), tol=1e-13)

    # Dense solve with symmetric elimination for cross-check
    free = np.moveaxis(np.asarray(bc.free_mask), range(3), range(3)[::-1]).reshape(-1) > 0.5
    bf = np.moveaxis(np.asarray(b), range(3), range(3)[::-1]).reshape(-1)
    A_mod = A.copy()
    A_mod[~free, :] = 0.0
    A_mod[:, ~free] = 0.0
    A_mod[~free, ~free] = 1.0
    x_dense = np.linalg.solve(A_mod, bf)
    x_flat = np.moveaxis(np.asarray(x), range(3), range(3)[::-1]).reshape(-1)
    assert np.allclose(x_flat, x_dense, atol=1e-9)


def test_mixed_precision_refinement_reaches_f64_accuracy():
    mesh = interval_mesh(200, 0.0, 1.0)
    st = assembly.assemble_scalar_stencil(mesh, "stiffness")
    op64 = StencilOperator.from_numpy(st, mesh.node_shape, dtype=jnp.float64)
    op32 = op64.astype(jnp.float32)
    bc = DirichletBC.from_masks([(face(mesh, 0, 0), 1.0), (face(mesh, 0, 1), 0.0)],
                                mesh.node_shape)
    bc32 = bc.astype(jnp.float32)
    a64 = bc.constrain_operator(op64.apply)
    a32 = bc32.constrain_operator(op32.apply)
    b = bc.constrain_rhs(op64.apply, jnp.zeros(mesh.node_shape, jnp.float64))
    x, stats = solve_refined(a32, a64, b, inv_diag32=(1.0 / op32.diagonal()),
                             tol=1e-11, refine_rounds=4)
    exact = 1.0 - mesh.axis_nodes(0)
    assert np.allclose(np.asarray(x), exact, atol=1e-9)
    assert float(stats.relative_residual) < 1e-10
