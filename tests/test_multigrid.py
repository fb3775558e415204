"""Geometric multigrid tests on the fake CPU backend: transfer adjointness,
V-cycle convergence, and MG-PCG agreement with plain CG."""

import numpy as np
import jax.numpy as jnp
import pytest

from pde_solver.config import set_config, get_config
from pde_solver.mesh import box_mesh, rectangle_mesh
from pde_solver.ops import assembly
from pde_solver.ops.bc import DirichletBC, all_boundary
from pde_solver.ops import multigrid as mg
from pde_solver.ops.linsolve import prepare_system, solve_stencil_system


def test_prolong_restrict_adjoint():
    rng = np.random.default_rng(0)
    for shape_c in [(5,), (5, 4), (4, 3, 3)]:
        d = len(shape_c)
        shape_f = tuple(2 * s - 1 for s in shape_c)
        u_c = jnp.asarray(rng.standard_normal(shape_c))
        v_f = jnp.asarray(rng.standard_normal(shape_f))
        # <P u_c, v_f> == <u_c, P^T v_f>
        lhs = float(jnp.vdot(mg.prolong(u_c, d).reshape(-1), v_f.reshape(-1)))
        rhs = float(jnp.vdot(u_c.reshape(-1), mg.restrict(v_f, d).reshape(-1)))
        assert abs(lhs - rhs) < 1e-12 * max(abs(lhs), 1.0)


def _poisson_hierarchy(cells, dtype=jnp.float64):
    mesh = box_mesh(*cells, (0, 0, 0), (1.0, 1.0, 1.0))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    b = assembly.assemble_load(mesh)
    sysm = prepare_system(K, mesh, bc, b, 1)

    def builder(mc):
        return (assembly.assemble_scalar_stencil(mc, "stiffness"),
                DirichletBC.from_masks([(all_boundary(mc), 0.0)], mc.node_shape))

    h = mg.build_hierarchy(mesh, sysm, builder, vdim=1, dtype=dtype)
    return mesh, sysm, h


def test_mg_pcg_poisson_converges_fast():
    mesh, sysm, h = _poisson_hierarchy((16, 16, 16))
    assert h is not None and len(h.levels) >= 3
    xh, k, relres = mg.solve_mg(h, sysm.b_hat, None, 1e-10, 100)
    assert float(relres) < 1e-10
    # MG should converge in O(10) iterations, far fewer than plain CG (~50+)
    assert int(k) <= 20, int(k)


def test_mg_pcg_matches_direct_solution():
    mesh, sysm, h = _poisson_hierarchy((8, 8, 8))
    xh, k, relres = mg.solve_mg(h, sysm.b_hat, None, 1e-12, 200)
    x = sysm.from_hat_x(np.asarray(xh, dtype=np.float64))
    # compare against the plain-CG path (no level builder → no MG)
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    b = assembly.assemble_load(mesh)
    x_ref, stats = solve_stencil_system(K, mesh, bc, b)
    assert np.allclose(x, x_ref, atol=1e-9)


def test_mg_elasticity_block_scaling():
    mesh = box_mesh(16, 8, 8, (0, 0, 0), (1.0, 0.2, 0.2))
    lam, mu = 1.21e11, 8.08e10
    K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=3)
    b = assembly.assemble_vector_load(mesh, np.array([0.0, 0.0, -7.65e4]))
    sysm = prepare_system(K, mesh, bc, b, 3)

    def builder(mc):
        return (assembly.assemble_elasticity_stencil(mc, lam, mu),
                DirichletBC.from_masks([(mc.face_mask(0, 0), 0.0)],
                                       mc.node_shape, vdim=3))

    h = mg.build_hierarchy(mesh, sysm, builder, vdim=3, dtype=jnp.float64)
    assert h is not None and len(h.levels) >= 3
    xh, k, relres = mg.solve_mg(h, sysm.b_hat, None, 1e-10, 200)
    assert float(relres) < 1e-10
    assert int(k) <= 70, int(k)  # vs thousands for (block-)Jacobi CG

    # solution parity vs plain-CG facade path
    set_config(use_multigrid=False)
    try:
        x_ref, _ = solve_stencil_system(K, mesh, bc, b, vdim=3)
    finally:
        set_config(use_multigrid=True)
    x = sysm.from_hat_x(np.asarray(xh, dtype=np.float64))
    rel = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
    assert rel < 1e-8, rel


def test_solve_facade_uses_mg_for_large_elasticity():
    from pde_solver.models.elasticity import solve_elasticity_nd
    set_config(mg_threshold=1000)
    try:
        mesh = box_mesh(16, 8, 8, (0, 0, 0), (1.0, 0.2, 0.2))
        vm, info = solve_elasticity_nd(mesh, 210e9, 0.3,
                                       np.array([0, 0, -7.65e4]), "3d", "stress")
        assert info["converged"]
        # MG iteration counts are small
        assert info["cg_iterations"] <= 100
    finally:
        set_config(mg_threshold=20000)


@pytest.mark.slow
def test_nested_mixed_precision_facade():
    """Mixed-precision + MG → solve_nested path reaches f64-level accuracy."""
    from pde_solver.models.elasticity import solve_elasticity_nd
    set_config(precision="mixed", mg_threshold=1000)
    try:
        mesh = box_mesh(16, 8, 8, (0, 0, 0), (1.0, 0.2, 0.2))
        vm_mixed, info = solve_elasticity_nd(mesh, 210e9, 0.3,
                                             np.array([0, 0, -7.65e4]),
                                             "3d", "stress")
        assert info["converged"], info
        assert info["relative_residual"] < 1e-9
        set_config(precision="f64")
        vm_f64, _ = solve_elasticity_nd(mesh, 210e9, 0.3,
                                        np.array([0, 0, -7.65e4]),
                                        "3d", "stress")
        rel = np.linalg.norm(vm_mixed - vm_f64) / np.linalg.norm(vm_f64)
        assert rel < 1e-6, rel
    finally:
        set_config(precision="auto", mg_threshold=20000)

@pytest.mark.slow
@pytest.mark.parametrize("variant", ["df", "df2"])
def test_fcycle_df_variants_reach_deep_accuracy(variant):
    """Both double-f32 F-cycles (host-looped and per-round-fused) reach
    well below the plain-f32 floor on an elasticity system (E ~ 2e11)."""
    mesh = box_mesh(16, 8, 8, (0, 0, 0), (1.0, 0.2, 0.2))
    lam, mu = 1.21e11, 8.08e10
    K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=3)
    b = assembly.assemble_vector_load(mesh, np.array([0.0, 0.0, -7.65e4]))
    sysm = prepare_system(K, mesh, bc, b, 3)

    def builder(mc):
        return (assembly.assemble_elasticity_stencil(mc, lam, mu),
                DirichletBC.from_masks([(mc.face_mask(0, 0), 0.0)],
                                       mc.node_shape, vdim=3))

    h = mg.build_hierarchy(mesh, sysm, builder, vdim=3, dtype=jnp.float32)
    assert h is not None and len(h.levels) >= 2
    ladder = mg.build_df_ladder(h, sysm, sysm.b_hat)
    solver = mg.solve_fcycle_df if variant == "df" else mg.solve_fcycle_df2
    x_hi, x_lo, iters, relres = solver(h, ladder, 1e-8, max_rounds=12)
    assert float(relres) < 1e-7, float(relres)

    # true f64 residual of the recombined solution against the host operator
    from pde_solver.ops import df32
    x_hat = df32.df_to_f64(np.asarray(x_hi), np.asarray(x_lo))
    from pde_solver.ops.linsolve import np_stencil_apply
    W64 = {o: np.asarray(w, dtype=np.float64)
           for o, w in zip(sysm.offsets, sysm.weights)}
    r = sysm.b_hat - np_stencil_apply(W64, x_hat, mesh.dim, 3)
    true_rel = np.linalg.norm(r.reshape(-1)) / np.linalg.norm(
        sysm.b_hat.reshape(-1))
    assert true_rel < 5e-7, true_rel


def test_mg_smooth_env_override(monkeypatch):
    """PDE_MG_SMOOTH overrides the Chebyshev degrees (the bench's
    V(2,1) flagship cycle rides this knob) without touching the default."""
    import numpy as np

    from pde_solver.mesh import rectangle_mesh
    from pde_solver.ops import assembly
    from pde_solver.ops import multigrid as mg
    from pde_solver.ops.bc import DirichletBC
    from pde_solver.ops.linsolve import prepare_system

    mesh = rectangle_mesh(16, 16, (0, 0), (1.0, 1.0))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    bc = DirichletBC.from_masks([(mesh.boundary_mask(), 0.0)],
                                mesh.node_shape)
    sysm = prepare_system(K, mesh, bc, np.zeros(mesh.node_shape), 1)

    def builder(mc):
        return (assembly.assemble_scalar_stencil(mc, "stiffness"),
                DirichletBC.from_masks([(mc.boundary_mask(), 0.0)],
                                       mc.node_shape))

    h_default = mg.build_hierarchy(mesh, sysm, builder)
    assert (h_default.pre_smooth, h_default.post_smooth) == (2, 2)
    monkeypatch.setenv("PDE_MG_SMOOTH", "2,1")
    h_21 = mg.build_hierarchy(mesh, sysm, builder)
    assert (h_21.pre_smooth, h_21.post_smooth) == (2, 1)
    # the asymmetric cycle must still solve the system
    b = np.zeros(mesh.node_shape)
    b[8, 8] = 1.0
    sys_b = prepare_system(K, mesh, bc, b, 1)
    import jax.numpy as jnp
    x, iters, relres = mg.mg_pcg(
        h_21, jnp.asarray(np.asarray(sys_b.b_hat), jnp.float32),
        jnp.zeros(mesh.node_shape, jnp.float32), 1e-6, 200)
    assert float(relres) < 1e-6
