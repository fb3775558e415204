"""Multi-device tests on the fake 8-device CPU mesh (SURVEY.md §4 point 3):
sharded halo-exchange SpMV and psum-CG must match the single-device path."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_solver.mesh import box_mesh, rectangle_mesh
from pde_solver.ops import assembly
from pde_solver.ops.bc import DirichletBC, all_boundary
from pde_solver.ops.stencil import StencilOperator
from pde_solver.ops.cg import pcg
from pde_solver.parallel import shard as psh

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


needs_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


@needs_multidevice
def test_sharded_heat_step_matches_single_device():
    # 16 nodes along x (divisible by 8 shards), 2D
    mesh = rectangle_mesh(15, 6, (0.0, 0.0), (1.0, 1.0))
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape,
                                dtype=jnp.float64)
    dev_mesh = psh.device_mesh(8)
    dt, kappa = 0.01, 1.3
    step, inputs = psh.build_sharded_heat_step(
        mesh, dev_mesh, kappa, dt, bc, dtype=jnp.float64, tol=1e-12, maxiter=2000)

    rng = np.random.default_rng(0)
    u0 = jnp.asarray(rng.random(mesh.node_shape))
    u0 = bc.apply_values(u0)
    u1, iters, relres = step(u0, *inputs)
    assert float(relres) < 1e-10

    # single-device reference with the ordinary operator
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    A = {o: M.get(o, 0.0) + dt * kappa * K.get(o, 0.0) for o in set(K) | set(M)}
    opA = StencilOperator.from_numpy(A, mesh.node_shape, dtype=jnp.float64)
    opM = StencilOperator.from_numpy(M, mesh.node_shape, dtype=jnp.float64)
    apply_c = bc.constrain_operator(opA.apply)
    bt = bc.constrain_rhs(opA.apply, opM.apply(u0))
    ref, stats = pcg(apply_c, bt, inv_diag=1.0 / opA.diagonal(), tol=1e-12)
    assert np.allclose(np.asarray(u1), np.asarray(ref), atol=1e-9)


@needs_multidevice
def test_sharded_3d_step_runs():
    mesh = box_mesh(7, 4, 4, (0, 0, 0), (1, 1, 1))  # 8 node-planes along x
    bc = DirichletBC.from_masks([(all_boundary(mesh), 5.0)], mesh.node_shape,
                                dtype=jnp.float64)
    dev_mesh = psh.device_mesh(8)
    step, inputs = psh.build_sharded_heat_step(
        mesh, dev_mesh, 1.0, 0.01, bc, dtype=jnp.float64, tol=1e-11)
    u0 = bc.apply_values(jnp.full(mesh.node_shape, 20.0, jnp.float64))
    u1, iters, relres = step(u0, *inputs)
    assert float(relres) < 1e-9
    assert np.isfinite(np.asarray(u1)).all()
    # boundary values preserved
    bmask = np.asarray(all_boundary(mesh))
    assert np.allclose(np.asarray(u1)[bmask], 5.0)


@needs_multidevice
def test_gspmd_operator_matches_dense_apply():
    mesh = box_mesh(7, 3, 3, (0, 0, 0), (1, 1, 1))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    dev_mesh = psh.device_mesh(8)
    op_sharded, sharding = psh.gspmd_operator(mesh, dev_mesh, K, dtype=jnp.float64)
    op_local = StencilOperator.from_numpy(K, mesh.node_shape, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.random(mesh.node_shape))
    xs = jax.device_put(x, sharding)
    y_sharded = jax.jit(op_sharded.apply)(xs)
    y_local = op_local.apply(x)
    assert np.allclose(np.asarray(y_sharded), np.asarray(y_local), atol=1e-12)


@needs_multidevice
def test_sharded_elasticity_matches_single_device():
    """Flagship path: vdim=3 block-scaled CG, NON-divisible axis-0 extent
    (14 node planes over 8 shards → identity-row padding), must match the
    single-device scaled CG to 1e-9 (VERDICT r1 item 4)."""
    from pde_solver.models.elasticity import lame_parameters
    from pde_solver.ops.linsolve import _jit_cg

    lam, mu = lame_parameters(210e9, 0.3, "3d")
    mesh = box_mesh(13, 5, 5, (0, 0, 0), (1.0, 0.5, 0.5))
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=3)
    dev_mesh = psh.device_mesh(8)
    cg, sysm = psh.build_sharded_elasticity_solve(
        mesh, dev_mesh, lam, mu, [0.0, 0.0, -9.81 * 7800.0], bc,
        dtype=jnp.float64)
    x, iters, relres = cg.solve(tol=1e-12, maxiter=4000)
    assert float(relres) < 1e-10

    w64 = tuple(jnp.asarray(W) for W in sysm.weights)
    ref, k, rr = _jit_cg(sysm.offsets, w64, jnp.asarray(sysm.b_hat),
                         jnp.zeros_like(jnp.asarray(sysm.b_hat)),
                         1e-12, 4000, 3, 3)
    ref = np.asarray(ref)
    assert np.abs(np.asarray(x) - ref).max() <= 1e-9 * np.abs(ref).max()


@needs_multidevice
def test_solve_stencil_system_sharded_config_route():
    """SolverConfig.shard_devices routes api-level solves through the
    domain-decomposed CG and still matches the closed-form answer."""
    from pde_solver.config import get_config, set_config
    from pde_solver.ops.linsolve import solve_stencil_system

    mesh = rectangle_mesh(13, 6, (0.0, 0.0), (1.0, 1.0))  # 14 planes / 8 dev
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    left = mesh.face_mask(0, 0)
    right = mesh.face_mask(0, 1)
    bc = DirichletBC.from_masks([(left, 20.0), (right, 0.0)], mesh.node_shape)
    rhs = np.zeros(mesh.node_shape)
    old = get_config()
    try:
        set_config(shard_devices=8)
        x, stats = solve_stencil_system(K, mesh, bc, rhs)
    finally:
        set_config(shard_devices=old.shard_devices)
    assert stats.converged
    # steady heat with linear-in-x Dirichlet data: u = 20 (1 - x)
    coords_x = np.linspace(0.0, 1.0, mesh.node_shape[0])
    expected = 20.0 * (1.0 - coords_x)[:, None] * np.ones(mesh.node_shape)
    assert np.abs(x - expected).max() < 1e-8


@needs_multidevice
def test_sharded_mg_composes_above_threshold():
    """shard_devices>1 on an MG-eligible solve must run SHARDED MG-PCG —
    round 2 silently dropped the shard request whenever MG engaged
    (ops/linsolve.py routed only `if ... hierarchy is None`)."""
    from pde_solver.config import config_overrides
    from pde_solver.ops.linsolve import solve_stencil_system

    mesh = box_mesh(40, 40, 40, (0, 0, 0), (1.0, 1.0, 1.0))  # 68,921 DOF
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    left = mesh.face_mask(0, 0)
    right = mesh.face_mask(0, 1)
    bc = DirichletBC.from_masks([(left, 20.0), (right, 0.0)], mesh.node_shape)
    rhs = np.zeros(mesh.node_shape)

    def builder(mc):
        return (assembly.assemble_scalar_stencil(mc, "stiffness"),
                DirichletBC.from_masks([(mc.face_mask(0, 0), 20.0),
                                        (mc.face_mask(0, 1), 0.0)],
                                       mc.node_shape))

    with config_overrides(shard_devices=8):
        x, stats = solve_stencil_system(K, mesh, bc, rhs,
                                        mg_level_builder=builder)
    assert stats.converged
    # MG-PCG iteration counts are O(10); plain (sharded) CG at 69k DOF to
    # 1e-11 needs hundreds — low count proves the V-cycle engaged
    assert int(stats.iterations) <= 60, int(stats.iterations)
    coords_x = np.linspace(0.0, 1.0, mesh.node_shape[0])
    expected = 20.0 * (1.0 - coords_x)[:, None, None] * np.ones(mesh.node_shape)
    assert np.abs(x - expected).max() < 1e-8


@needs_multidevice
def test_sharded_mg_mixed_precision_route():
    """precision=mixed + shard_devices>1 + MG runs sharded MG-PCG in float64
    (sharded MG has no double-f32 ladder) and meets the f64 tolerance."""
    from pde_solver.config import config_overrides
    from pde_solver.ops.linsolve import solve_stencil_system

    mesh = box_mesh(40, 40, 40, (0, 0, 0), (1.0, 1.0, 1.0))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 20.0),
                                 (mesh.face_mask(0, 1), 0.0)],
                                mesh.node_shape)
    rhs = np.zeros(mesh.node_shape)

    def builder(mc):
        return (assembly.assemble_scalar_stencil(mc, "stiffness"),
                DirichletBC.from_masks([(mc.face_mask(0, 0), 20.0),
                                        (mc.face_mask(0, 1), 0.0)],
                                       mc.node_shape))

    with config_overrides(shard_devices=8, precision="mixed", tol=1e-9):
        x, stats = solve_stencil_system(K, mesh, bc, rhs,
                                        mg_level_builder=builder)
    assert stats.converged
    coords_x = np.linspace(0.0, 1.0, mesh.node_shape[0])
    expected = 20.0 * (1.0 - coords_x)[:, None, None] * np.ones(mesh.node_shape)
    assert np.abs(x - expected).max() < 1e-6


@needs_multidevice
@pytest.mark.parametrize("shard", [0, 4])
def test_f32_refinement_converges_sharded_and_not(shard):
    """benchmarks/f32_refinement.py at a size where float32 refinement does
    not stall, on one device and sharded over four: each round cuts the
    true residual a hundredfold and 5 rounds reach 1e-9."""
    from benchmarks.f32_refinement import refine

    hist = refine((32, 8, 8), shard=shard, rounds=5, log=lambda m: None)
    relres = [h[0] for h in hist[1:]]
    assert all(b < 0.01 * a for a, b in zip(relres[:3], relres[1:4])), relres
    assert relres[-1] <= 1e-9, relres


@needs_multidevice
def test_sharded_transient_scan_matches_single_device():
    """shard_devices>1 routes run_transient through the shard_mapped
    θ-scheme scan (VERDICT r2 item 4: transient scans previously always ran
    single-device)."""
    from pde_solver.config import config_overrides
    from pde_solver.models import heat

    mesh = rectangle_mesh(21, 8, (0.0, 0.0), (1.0, 1.0))  # 22 rows / 8 dev
    p = heat.HeatProblem(
        mesh=mesh, diffusivity=1.0,
        bc_builder=lambda m: [(m.face_mask(0, 0), 20.0),
                              (m.face_mask(0, 1), 0.0)],
        T_initial=0.0, dt=0.01, num_steps=12)
    _, ref_values, ref_info = heat.solve_heat_problem(p)
    with config_overrides(shard_devices=8):
        _, sh_values, sh_info = heat.solve_heat_problem(p)
    assert sh_info["relative_residual"] <= 1e-9
    assert np.abs(sh_values - ref_values).max() < 1e-8 * np.abs(ref_values).max()


@needs_multidevice
def test_sharded_transient_scan_vector_block():
    """Sharded Newmark-free path: the θ-scan with block (vdim>1) scaling —
    elastodynamics-style systems shard too (block-Cholesky to_hat/from_hat
    inside shard_map)."""
    from pde_solver.config import config_overrides
    from pde_solver.ops.timestepping import run_transient
    from pde_solver.models.elasticity import lame_parameters
    from pde_solver.models.elasticity import assemble_vector_mass

    mesh = rectangle_mesh(13, 6, (0.0, 0.0), (1.0, 1.0))
    lam, mu = lame_parameters(1e6, 0.3, "plane_stress")
    K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
    M = assemble_vector_mass(mesh, 100.0)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=2)
    b = assembly.assemble_vector_load(mesh, np.array([0.0, -10.0]))
    u0 = np.zeros(mesh.node_shape + (2,))
    ref = run_transient(K, M, mesh, bc, b, u0, dt=1e-3, num_steps=8, vdim=2)
    with config_overrides(shard_devices=8):
        sh = run_transient(K, M, mesh, bc, b, u0, dt=1e-3, num_steps=8,
                           vdim=2)
    scale = max(np.abs(ref.values).max(), 1e-30)
    assert np.abs(sh.values - ref.values).max() < 1e-8 * scale


@needs_multidevice
def test_sharded_cnab2_advection_matches_single_device():
    """CNAB2's AB2-history carry composes with the sharded θ-scan: the
    separate convection operand rides the same halo-exchange applies."""
    from pde_solver.config import config_overrides
    from pde_solver.models.advection import (AdvectionProblem,
                                                 solve_advection_problem)

    mesh = rectangle_mesh(21, 8, (0.0, 0.0), (1.0, 1.0))
    p = AdvectionProblem(mesh=mesh, velocity=[0.8, -0.3], diffusivity=0.02,
                         initial_type="gaussian", pulse_center=(0.4, 0.6),
                         pulse_width=0.15, dt=0.005, num_steps=10)
    _, ref_values, ref_info = solve_advection_problem(p)
    assert ref_info["scheme"] == "cnab2"
    with config_overrides(shard_devices=8):
        _, sh_values, sh_info = solve_advection_problem(p)
    assert sh_info["converged"]
    scale = max(np.abs(ref_values).max(), 1e-30)
    assert np.abs(sh_values - ref_values).max() < 1e-6 * scale


@needs_multidevice
def test_sharded_time_mod_matches_single_device():
    """Sinusoidal Dirichlet + source driving inside the sharded scan (was
    rejected with ValueError before round 4's continuation): parity with
    the single-device tmod scan."""
    from pde_solver.config import config_overrides
    from pde_solver.models import heat

    mesh = rectangle_mesh(21, 8, (0.0, 0.0), (1.0, 1.0))
    p = heat.HeatProblem(
        mesh=mesh, diffusivity=1.0,
        bc_builder=lambda m: [(m.face_mask(0, 0), 20.0),
                              (m.face_mask(0, 1), 0.0)],
        T_initial=0.0, dt=0.01, num_steps=12,
        bc_amp_pairs=[(mesh.face_mask(0, 0), 5.0)],
        source_type="constant", source_value=1.0, source_amp=0.5,
        mod_omega=6.0, mod_phase=0.3)
    _, ref_values, ref_info = heat.solve_heat_problem(p)
    with config_overrides(shard_devices=8):
        _, sh_values, sh_info = heat.solve_heat_problem(p)
    assert sh_info["relative_residual"] <= 1e-6
    scale = max(np.abs(ref_values).max(), 1e-30)
    assert np.abs(sh_values - ref_values).max() < 1e-6 * scale
    # the driving actually drove something: trajectory isn't monotone decay
    assert np.abs(ref_values[1:] - ref_values[:-1]).max() > 0.0


@needs_multidevice
def test_shard_hierarchy_cache_never_aliases_stale_solver():
    """VERDICT r3 item 6: the solver cache must not reuse a sharded solver
    for a DIFFERENT hierarchy that happens to share id(h) with a collected
    one.  Contract: keyless entries pin the hierarchy object and gate reuse
    on identity; content-keyed entries reuse across equal-content rebuilds."""
    from pde_solver.ops import multigrid as mg
    from pde_solver.ops.linsolve import prepare_system
    from pde_solver.parallel import shard_mg
    from pde_solver.parallel.shard import device_mesh

    def build(n):
        mesh = box_mesh(n, n, n, (0, 0, 0), (1.0, 1.0, 1.0))
        K = assembly.assemble_scalar_stencil(mesh, "stiffness")
        bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)],
                                    mesh.node_shape)
        b = assembly.assemble_load(mesh)
        sysm = prepare_system(K, mesh, bc, b, 1)

        def builder(mc):
            return (assembly.assemble_scalar_stencil(mc, "stiffness"),
                    DirichletBC.from_masks([(all_boundary(mc), 0.0)],
                                           mc.node_shape))

        return mg.build_hierarchy(mesh, sysm, builder, vdim=1,
                                  dtype=jnp.float32)

    dev = device_mesh(8)
    shard_mg._SOLVER_CACHE.clear()

    h1 = build(16)
    s1 = shard_mg.shard_hierarchy(h1, dev)
    assert shard_mg.shard_hierarchy(h1, dev) is s1  # same object → cache hit

    # keyless entries pin the hierarchy: its id cannot be recycled while the
    # entry lives, so a same-id alias to a different hierarchy is impossible
    assert any(entry[0] is h1 for entry in shard_mg._SOLVER_CACHE.values())

    h2 = build(24)  # different content, no key → must NOT reuse s1
    s2 = shard_mg.shard_hierarchy(h2, dev)
    assert s2 is not s1

    # content key: equal-content rebuild (new object) reuses the solver
    h3 = build(16)
    assert h3 is not h1
    s3a = shard_mg.shard_hierarchy(h3, dev, key=("ck", 16))
    s3b = shard_mg.shard_hierarchy(build(16), dev, key=("ck", 16))
    assert s3b is s3a
    # ...and a different content key builds afresh
    s4 = shard_mg.shard_hierarchy(h2, dev, key=("ck", 24))
    assert s4 is not s3a


@needs_multidevice
def test_sharded_newmark_matches_single_device():
    """shard_devices>1 routes run_newmark through the shard_mapped Newmark
    scan (VERDICT r3 item 5: vector transient sharding must be witnessed);
    trajectories must match the single-device scan."""
    from pde_solver.config import config_overrides
    from pde_solver.ops.timestepping import run_newmark
    from pde_solver.models.elasticity import (assemble_vector_mass,
                                                  lame_parameters)

    mesh = rectangle_mesh(13, 6, (0.0, 0.0), (1.0, 1.0))
    lam, mu = lame_parameters(1e6, 0.3, "plane_stress")
    K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
    M = assemble_vector_mass(mesh, 100.0)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=2)
    f = assembly.assemble_vector_load(mesh, np.array([0.0, -10.0]))
    u0 = np.zeros(mesh.node_shape + (2,))
    v0 = np.zeros_like(u0)
    ref = run_newmark(K, M, mesh, bc, f, u0, v0, dt=1e-3, num_steps=8,
                      vdim=2)
    with config_overrides(shard_devices=8):
        sh = run_newmark(K, M, mesh, bc, f, u0, v0, dt=1e-3, num_steps=8,
                         vdim=2)
    scale = max(np.abs(ref.values).max(), 1e-30)
    assert np.abs(sh.values - ref.values).max() < 1e-6 * scale
    vscale = max(np.abs(ref.velocities).max(), 1e-30)
    assert np.abs(sh.velocities - ref.velocities).max() < 1e-6 * vscale


# ----------------------------------------------------------------------
# 2-D domain decomposition (grid axes 0+1 over an a×b device mesh) —
# VERDICT r4 item 3.  The simplicial P1 stencil has diagonal (corner)
# couplings, so these tests also witness the transitive corner-halo
# exchange in local_stencil_apply.
# ----------------------------------------------------------------------

@needs_multidevice
def test_local_stencil_apply_2d_mesh_matches_dense():
    """Halo-exchange apply on a 4×2 device mesh == the dense single-device
    apply, including the corner couplings (non-divisible extents on BOTH
    decomposed axes would need padding — use divisible ones here to test
    the apply in isolation)."""
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = box_mesh(7, 5, 4, (0, 0, 0), (1.0, 1.0, 1.0))  # nodes (8, 6, 5)
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    offsets = tuple(sorted(K))
    assert any(o[0] != 0 and o[1] != 0 for o in offsets)  # corner couplings
    weights = tuple(jnp.asarray(K[o], jnp.float64) for o in offsets)
    dev = psh.device_mesh(shape=(4, 2))
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.random(mesh.node_shape))

    spec = P(psh.AXIS, psh.AXIS1, None)
    fn = shard_map(
        lambda xv, *w: psh.local_stencil_apply(offsets, w, xv, 1,
                                               axis1_name=psh.AXIS1),
        mesh=dev, in_specs=(spec,) + tuple(spec for _ in offsets),
        out_specs=spec, check_vma=False)
    y2d = jax.jit(fn)(jax.device_put(x, NamedSharding(dev, spec)),
                      *(jax.device_put(w, NamedSharding(dev, spec))
                        for w in weights))
    op = StencilOperator.from_numpy(K, mesh.node_shape, dtype=jnp.float64)
    y_ref = op.apply(x)
    assert np.allclose(np.asarray(y2d), np.asarray(y_ref), atol=1e-12)


@needs_multidevice
def test_sharded_cg_2d_mesh_matches_single_device():
    """ShardedScaledCG over a 4×2 mesh, NON-divisible extents on both
    decomposed axes (identity-row padding on each), vdim=1."""
    from pde_solver.ops.linsolve import _jit_cg, prepare_system

    mesh = rectangle_mesh(13, 8, (0.0, 0.0), (1.0, 1.0))  # nodes (14, 9)
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 20.0),
                                 (mesh.face_mask(0, 1), 0.0)],
                                mesh.node_shape)
    b = assembly.assemble_load(mesh)
    sysm = prepare_system(K, mesh, bc, b, 1)
    dev = psh.device_mesh(shape=(4, 2))
    cg = psh.ShardedScaledCG(sysm, mesh.dim, 1, dev, dtype=jnp.float64)
    x, iters, relres = cg.solve(tol=1e-12, maxiter=4000)
    assert float(relres) < 1e-10

    w64 = tuple(jnp.asarray(W) for W in sysm.weights)
    ref, k, rr = _jit_cg(sysm.offsets, w64, jnp.asarray(sysm.b_hat),
                         jnp.zeros_like(jnp.asarray(sysm.b_hat)),
                         1e-12, 4000, 2, 1)
    ref = np.asarray(ref)
    assert np.abs(np.asarray(x) - ref).max() <= 1e-9 * np.abs(ref).max()


@needs_multidevice
def test_sharded_elasticity_2d_mesh_vdim3():
    """The flagship shape class on a 2-D device mesh: vdim=3 block-scaled
    CG, 4×2 decomposition of grid axes 0/1, non-divisible both ways."""
    from pde_solver.models.elasticity import lame_parameters
    from pde_solver.ops.linsolve import _jit_cg, prepare_system

    lam, mu = lame_parameters(210e9, 0.3, "3d")
    mesh = box_mesh(9, 5, 4, (0, 0, 0), (1.0, 0.5, 0.5))  # nodes (10, 6, 5)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=3)
    K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
    b = assembly.assemble_vector_load(mesh, np.array([0.0, 0.0,
                                                      -9.81 * 7800.0]))
    sysm = prepare_system(K, mesh, bc, b, 3)
    dev = psh.device_mesh(shape=(4, 2))
    cg = psh.ShardedScaledCG(sysm, mesh.dim, 3, dev, dtype=jnp.float64)
    x, iters, relres = cg.solve(tol=1e-12, maxiter=6000)
    assert float(relres) < 1e-10

    w64 = tuple(jnp.asarray(W) for W in sysm.weights)
    ref, k, rr = _jit_cg(sysm.offsets, w64, jnp.asarray(sysm.b_hat),
                         jnp.zeros_like(jnp.asarray(sysm.b_hat)),
                         1e-12, 6000, 3, 3)
    ref = np.asarray(ref)
    assert np.abs(np.asarray(x) - ref).max() <= 1e-9 * np.abs(ref).max()


@needs_multidevice
def test_shard_grid_config_route():
    """SolverConfig.shard_grid="4,2" routes solve_stencil_system through the
    2-D decomposed CG and still matches the closed-form answer."""
    from pde_solver.config import config_overrides
    from pde_solver.ops.linsolve import solve_stencil_system

    mesh = rectangle_mesh(13, 9, (0.0, 0.0), (1.0, 1.0))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 20.0),
                                 (mesh.face_mask(0, 1), 0.0)],
                                mesh.node_shape)
    rhs = np.zeros(mesh.node_shape)
    with config_overrides(shard_grid="4,2", host_direct_threshold=0):
        x, stats = solve_stencil_system(K, mesh, bc, rhs)
    assert stats.converged
    coords_x = np.linspace(0.0, 1.0, mesh.node_shape[0])
    expected = 20.0 * (1.0 - coords_x)[:, None] * np.ones(mesh.node_shape)
    assert np.abs(x - expected).max() < 1e-8


@needs_multidevice
def test_shard_grid_falls_back_when_unfactorable():
    """A shard_grid that exceeds the device count resolves to None (1-D
    split) instead of crashing."""
    from pde_solver.config import config_overrides, get_config

    with config_overrides(shard_grid="16,4"):
        assert get_config().resolved_shard_grid() is None
    with config_overrides(shard_grid="4,2"):
        assert get_config().resolved_shard_grid() == (4, 2)
        assert get_config().resolved_shard_devices() == 8
    with config_overrides(shard_grid="4x2"):
        assert get_config().resolved_shard_grid() == (4, 2)
    with config_overrides(shard_grid="8,1"):  # b<2 is just the 1-D split
        assert get_config().resolved_shard_grid() is None
