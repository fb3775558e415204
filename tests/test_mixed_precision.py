"""Mixed-precision path (the accelerator default) exercised on CPU: f32 device CG +
host f64 refinement must reach f64-level accuracy."""

import numpy as np
import pytest

from pde_solver.config import set_config, get_config
from pde_solver.mesh import box_mesh, interval_mesh
from pde_solver.models import heat
from pde_solver.models.elasticity import solve_elasticity_nd


@pytest.fixture()
def mixed_cfg():
    old = get_config()
    set_config(precision="mixed")
    yield
    set_config(precision=old.precision)


def test_mixed_heat_steady_matches_analytic(mixed_cfg):
    mesh = interval_mesh(128, 0.0, 2.0)
    p = heat.HeatProblem(mesh=mesh, steady=True,
                         bc_pairs=[(mesh.face_mask(0, 0), 20.0),
                                   (mesh.face_mask(0, 1), 0.0)])
    _, values, info = heat.solve_heat_problem(p)
    exact = 20.0 * (1 - mesh.axis_nodes(0) / 2.0)
    assert info["converged"]
    assert np.max(np.abs(values[0] - exact)) < 1e-7


def test_mixed_elasticity_matches_f64(mixed_cfg):
    mesh = box_mesh(8, 4, 4, (0, 0, 0), (1.0, 0.2, 0.2))
    body = np.array([0.0, 0.0, -7.65e4])
    vm_mixed, info = solve_elasticity_nd(mesh, 210e9, 0.3, body, "3d", "stress")
    assert info["converged"], info
    set_config(precision="f64")
    vm_f64, _ = solve_elasticity_nd(mesh, 210e9, 0.3, body, "3d", "stress")
    rel = np.linalg.norm(vm_mixed - vm_f64) / np.linalg.norm(vm_f64)
    assert rel < 1e-6, rel


def test_mixed_transient_matches_f64(mixed_cfg):
    mesh = interval_mesh(64, 0.0, 1.0)
    p = heat.HeatProblem(mesh=mesh, dt=0.005, num_steps=10, T_initial=20.0,
                         bc_pairs=[(mesh.face_mask(0, 0), 0.0),
                                   (mesh.face_mask(0, 1), 0.0)])
    _, v_mixed, _ = heat.solve_heat_problem(p)
    set_config(precision="f64")
    _, v_f64, _ = heat.solve_heat_problem(p)
    rel = np.linalg.norm(v_mixed - v_f64) / np.linalg.norm(v_f64)
    assert rel < 5e-6, rel


def test_prepare_system_operator_cache(monkeypatch):
    """prepare_system's cached operator part must reproduce the fresh
    result exactly for new RHS / BC values (value changes enter via b̂)."""
    from pde_solver.mesh import box_mesh as _box
    from pde_solver.ops import assembly, linsolve
    from pde_solver.ops.bc import DirichletBC

    monkeypatch.setattr(linsolve, "_PREP_CACHE_MIN_DOF", 10)
    linsolve._PREP_CACHE.clear()
    mesh = _box(4, 4, 4, (0, 0, 0), (1.0, 1.0, 1.0))
    from pde_solver.models.elasticity import lame_parameters
    lam, mu = lame_parameters(1e6, 0.3, "3d")
    K = assembly.assemble_elasticity_stencil(mesh, lam, mu)

    def mk(val, rhs_scale):
        bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), val)],
                                    mesh.node_shape, vdim=3)
        rhs = rhs_scale * np.ones(mesh.node_shape + (3,))
        return linsolve.prepare_system(K, mesh, bc, rhs, 3)

    s1 = mk(0.0, 1.0)
    assert len(linsolve._PREP_CACHE) == 1
    s2 = mk(1e-3, 2.0)           # different values/rhs → operator cached
    assert len(linsolve._PREP_CACHE) == 1
    for W1, W2 in zip(s1.weights, s2.weights):
        assert W1 is W2          # identical cached arrays
    # fresh (cache-cleared) result must match the cached-path b_hat exactly
    linsolve._PREP_CACHE.clear()
    s2_fresh = mk(1e-3, 2.0)
    np.testing.assert_allclose(s2.b_hat, s2_fresh.b_hat, rtol=0, atol=0)
    np.testing.assert_allclose(s2.gvals, s2_fresh.gvals, rtol=0, atol=0)
    linsolve._PREP_CACHE.clear()


def test_snapshot_thinning_matches_dense_trajectory():
    """Thinned scan (snapshot_max_frames) keeps every k-th frame plus the
    final state, bitwise-matching the dense trajectory at those times."""
    from pde_solver.config import SolverConfig
    from pde_solver.mesh import rectangle_mesh

    mesh = rectangle_mesh(10, 8, (0.0, 0.0), (1.0, 1.0))
    nsteps = 13  # prime: exercises the remainder tail

    def make():
        return heat.HeatProblem(
            mesh=mesh, diffusivity=1.0,
            bc_builder=lambda m: [(m.boundary_mask(), 0.0)],
            T_initial=20.0, dt=0.01, num_steps=nsteps)

    dense_cfg = SolverConfig(precision="f64")
    thin_cfg = SolverConfig(precision="f64", snapshot_max_frames=4)
    t_d, v_d, _ = heat.solve_heat_problem(make(), dense_cfg)
    t_t, v_t, _ = heat.solve_heat_problem(make(), thin_cfg)
    assert v_d.shape[0] == nsteps + 1
    assert v_t.shape[0] < v_d.shape[0]
    assert t_t[-1] == t_d[-1]
    for tt, vv in zip(t_t, v_t):
        j = int(round(tt / 0.01))
        np.testing.assert_allclose(vv, v_d[j], rtol=0, atol=1e-12)


def test_mg_operator_cache_hits_and_stays_correct():
    """Repeated solves of the same operator with DIFFERENT BC values (the
    agent follow-up pattern) must hit the hierarchy/ladder cache and still
    produce the right answer; a changed coefficient must miss."""
    from pde_solver.config import SolverConfig
    from pde_solver.ops import linsolve

    mesh = box_mesh(12, 12, 12, (0, 0, 0), (1.0, 1.0, 1.0))
    cfg = SolverConfig(precision="mixed", mg_threshold=100,
                       host_direct_threshold=0)

    def solve(T_left, diff):
        return heat.solve_heat_problem(heat.HeatProblem(
            mesh=mesh, diffusivity=diff,
            bc_builder=lambda m: [(m.face_mask(0, 0), T_left),
                                  (m.face_mask(0, 1), 0.0)],
            steady=True), cfg)

    linsolve._MG_CACHE.clear()
    _, v100, _ = solve(100.0, 1.0)
    assert len(linsolve._MG_CACHE) == 1
    _, v50, _ = solve(50.0, 1.0)     # value-only change → cache hit
    assert len(linsolve._MG_CACHE) == 1
    # linear problem: halving the boundary value halves the solution
    np.testing.assert_allclose(v50, 0.5 * v100, rtol=0, atol=1e-6 * 100)
    _, v_k, _ = solve(100.0, 2.0)    # coefficient change → new entry
    assert len(linsolve._MG_CACHE) == 2
    # steady heat with uniform kappa: solution independent of kappa scale
    np.testing.assert_allclose(v_k, v100, rtol=0, atol=1e-5 * 100)


@pytest.mark.parametrize("precision, tol", [("f32", 1e-5), ("mixed", 1e-7)])
def test_transient_mg_step_solves_match_plain_cg(precision, tol):
    """MG-PCG per-step solves (mg_level_builder path) match plain-CG
    stepping with a substantially lower inner-iteration count; in ``mixed``
    (f64 state, f32 MG-PCG corrections) both stay within ``tol`` of f64
    stepping."""
    from pde_solver.config import SolverConfig

    mesh = box_mesh(16, 16, 16, (0, 0, 0), (1.0, 1.0, 1.0))

    def make():
        return heat.HeatProblem(
            mesh=mesh, diffusivity=1.0,
            bc_builder=lambda m: [(m.boundary_mask(), 0.0)],
            T_initial=20.0, dt=0.01, num_steps=6)

    cfg_mg = SolverConfig(precision=precision, mg_threshold=100,
                          transient_mg_threshold=100,
                          transient_inner_tol=1e-8)
    cfg_cg = SolverConfig(precision=precision, use_multigrid=False,
                          transient_inner_tol=1e-8)
    _, v_mg, info_mg = heat.solve_heat_problem(make(), cfg_mg)
    _, v_cg, info_cg = heat.solve_heat_problem(make(), cfg_cg)
    ref = v_cg
    if precision == "mixed":
        _, ref, _ = heat.solve_heat_problem(make(), SolverConfig(
            precision="f64", use_multigrid=False))
        assert np.abs(v_cg - ref).max() < tol * np.abs(ref).max()
    scale = np.abs(ref).max()
    assert np.abs(v_mg - ref).max() < tol * scale, (
        np.abs(v_mg - ref).max() / scale)
    assert info_mg["cg_iterations"] < 0.5 * info_cg["cg_iterations"], (
        info_mg["cg_iterations"], info_cg["cg_iterations"])
