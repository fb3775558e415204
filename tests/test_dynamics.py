"""Newmark-β elastodynamics: energy conservation, dense-reference parity,
and block-scaled (vdim>1) transient scan coverage.

The reference has no dynamics at all (its elasticity is static only,
fenics_mcp_server.py:1470-1892) — these tests pin down the new capability.
"""

import numpy as np
import pytest

from pde_solver.config import SolverConfig
from pde_solver.mesh import box_mesh, interval_mesh, rectangle_mesh
from pde_solver.models.elasticity import (
    assemble_vector_mass,
    lame_parameters,
    solve_elasticity_dynamic,
    solve_elasticity_nd,
)
from pde_solver.ops import assembly
from pde_solver.ops.bc import DirichletBC
from pde_solver.ops.timestepping import run_newmark, run_transient

CFG64 = SolverConfig(precision="f64", tol=1e-12)


def _dense_perm(mesh, vdim):
    """Map C-order grid DOFs → stencil_to_dense's x-fastest numbering."""
    shape = mesh.node_shape
    N = int(np.prod(shape))
    idx = np.arange(N).reshape(tuple(reversed(shape))).transpose(
        tuple(reversed(range(len(shape)))))
    return (idx.reshape(-1)[:, None] * vdim + np.arange(vdim)).reshape(-1)


def _dense_newmark(Kd, Md, free, f, u0, v0, dt, num_steps,
                   beta=0.25, gamma=0.5):
    """Dense numpy Newmark on the constrained subsystem (reference)."""
    idx = np.flatnonzero(free.reshape(-1))
    K = Kd[np.ix_(idx, idx)]
    M = Md[np.ix_(idx, idx)]
    ff = f.reshape(-1)[idx]
    u = u0.reshape(-1)[idx].copy()
    v = v0.reshape(-1)[idx].copy()
    a = np.linalg.solve(M, ff - K @ u)
    A_eff = M + beta * dt * dt * K
    us = [u0.reshape(-1).copy()]
    for _ in range(num_steps):
        u_pred = u + dt * v + dt * dt * (0.5 - beta) * a
        a_new = np.linalg.solve(A_eff, ff - K @ u_pred)
        u = u_pred + beta * dt * dt * a_new
        v = v + dt * ((1.0 - gamma) * a + gamma * a_new)
        a = a_new
        full = np.zeros(u0.size)
        full[idx] = u
        us.append(full)
    return np.stack(us)


def test_newmark_matches_dense_reference_2d():
    """Block-scaled (vdim=2) Newmark scan vs dense numpy integration."""
    mesh = rectangle_mesh(6, 5, (0.0, 0.0), (1.2, 1.0))
    lam, mu = lame_parameters(10.0, 0.3, "plane_stress")
    K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
    M = assemble_vector_mass(mesh, rho=2.0)
    f = assembly.assemble_vector_load(mesh, np.array([0.0, -1.0]))
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=2)
    shape = mesh.node_shape + (2,)
    u0 = np.zeros(shape)
    v0 = np.zeros(shape)
    dt, n = 0.02, 25

    res = run_newmark(K, M, mesh, bc, f, u0, v0, dt, n, vdim=2, config=CFG64)

    Kd = assembly.stencil_to_dense(mesh, K, vdim=2)
    Md = assembly.stencil_to_dense(mesh, M, vdim=2)
    # reorder grid-C-order vectors into the dense x-fastest DOF numbering
    perm = _dense_perm(mesh, 2)
    def reorder(g):
        out = np.empty(g.size)
        out[perm] = g.reshape(-1)
        return out
    ref = _dense_newmark(Kd, Md, reorder(np.asarray(bc.free_mask)),
                         reorder(f), reorder(u0), reorder(v0), dt, n)

    got = np.stack([reorder(res.values[k]) for k in range(n + 1)])
    err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert err < 1e-9, err


def test_newmark_energy_conservation():
    """β=¼, γ=½, f=0: discrete energy ½vᵀMv + ½uᵀKu is exactly conserved."""
    mesh = interval_mesh(24, 0.0, 1.0)
    E, rho = 50.0, 1.0
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    K = {o: E * W for o, W in K.items()}
    m = assembly.assemble_scalar_stencil(mesh, "mass")
    M = {o: rho * W for o, W in m.items()}
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape)
    x = mesh.axis_nodes(0)
    u0 = 0.01 * np.sin(0.5 * np.pi * x)      # satisfies u(0)=0
    v0 = np.zeros_like(u0)
    f = np.zeros_like(u0)
    dt, n = 0.005, 200

    res = run_newmark(K, M, mesh, bc, f, u0, v0, dt, n, config=CFG64)

    Kd = assembly.stencil_to_dense(mesh, K)
    Md = assembly.stencil_to_dense(mesh, m)
    Md = rho * Md
    energies = []
    for k in range(n + 1):
        u = res.values[k].reshape(-1)
        v = res.velocities[k].reshape(-1)
        energies.append(0.5 * v @ Md @ v + 0.5 * u @ Kd @ u)
    energies = np.asarray(energies)
    drift = np.abs(energies - energies[0]).max() / energies[0]
    assert drift < 1e-8, drift


def test_newmark_bar_frequency():
    """Fixed-free bar fundamental frequency ω₁ = (π/2)·√(E/ρ)/L."""
    L, E, rho = 1.0, 100.0, 1.0
    mesh = interval_mesh(64, 0.0, L)
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    K = {o: E * W for o, W in K.items()}
    m = assembly.assemble_scalar_stencil(mesh, "mass")
    M = {o: rho * W for o, W in m.items()}
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape)
    x = mesh.axis_nodes(0)
    u0 = 1e-3 * np.sin(0.5 * np.pi * x / L)  # ≈ first mode shape
    omega = 0.5 * np.pi * np.sqrt(E / rho) / L
    period = 2 * np.pi / omega
    n = 160
    dt = period / n

    res = run_newmark(K, M, mesh, bc, np.zeros_like(u0), u0,
                      np.zeros_like(u0), dt, n, config=CFG64)
    tip = res.values[:, -1]
    # after one full period the tip returns to its initial displacement
    # (Newmark period error is O(ω²Δt²) ≈ (2π/160)² ≈ 1.5e-3)
    assert abs(tip[-1] - tip[0]) / abs(tip[0]) < 2e-2
    # and the half-period value is the negated initial displacement
    assert abs(tip[n // 2] + tip[0]) / abs(tip[0]) < 2e-2


def test_elastodynamics_model_entry():
    """Model-level API: cantilever released under gravity oscillates about
    the static equilibrium with bounded amplitude (stability check)."""
    mesh = box_mesh(8, 4, 4, (0, 0, 0), (1.0, 0.25, 0.25))
    E, nu, rho = 1e6, 0.3, 10.0
    g = np.array([0.0, 0.0, -9.81 * rho])
    res, info = solve_elasticity_dynamic(
        mesh, E, nu, rho, g, "3d", dt=2e-3, num_steps=40, config=CFG64)
    assert res.values.shape[0] == 41
    assert info["cg_iterations"] > 0
    uz = res.values[..., 2].reshape(41, -1)
    # static solution via the stationary solver bounds the oscillation:
    # u(t) swings between 0 and ~2× the static deflection
    disp, _ = solve_elasticity_nd(mesh, E, nu, g, "3d", config=CFG64)
    max_dyn = np.abs(uz).max()
    assert max_dyn < 10.0 * max(np.abs(disp).max(), 1e-12) + 1e-9
    # clamped face never moves
    assert np.abs(res.values[:, 0, :, :, :]).max() == 0.0


def test_newmark_mg_step_solves_match_plain():
    """MG-PCG Newmark step solves (transient_mg_threshold crossed) match
    the plain-CG path."""
    mesh = box_mesh(8, 4, 4, (0, 0, 0), (1.0, 0.25, 0.25))
    g = np.array([0.0, 0.0, -98.1])
    kw = dict(dt=2e-3, num_steps=10)
    cfg_mg = SolverConfig(precision="f64", tol=1e-12, mg_threshold=100,
                          transient_mg_threshold=100)
    res_mg, info_mg = solve_elasticity_dynamic(
        mesh, 1e6, 0.3, 10.0, g, "3d", config=cfg_mg, **kw)
    res_cg, info_cg = solve_elasticity_dynamic(
        mesh, 1e6, 0.3, 10.0, g, "3d", config=CFG64, **kw)
    scale = np.abs(res_cg.values).max()
    assert np.abs(res_mg.values - res_cg.values).max() < 1e-8 * scale
    assert info_mg["cg_iterations"] < info_cg["cg_iterations"]


def test_transient_heat_vector_block_path():
    """run_transient with vdim>1 (block-scaled scan) matches two independent
    scalar runs stacked — a vector heat system with decoupled components."""
    mesh = rectangle_mesh(9, 7, (0.0, 0.0), (1.0, 1.0))
    Ks = assembly.assemble_scalar_stencil(mesh, "stiffness")
    ms = assembly.assemble_scalar_stencil(mesh, "mass")
    eye = np.eye(2)
    K = {o: W[..., None, None] * eye for o, W in Ks.items()}
    M = {o: W[..., None, None] * eye for o, W in ms.items()}
    bmask = mesh.boundary_mask()
    bc2 = DirichletBC.from_masks([(bmask, 0.0)], mesh.node_shape, vdim=2)
    bc1 = DirichletBC.from_masks([(bmask, 0.0)], mesh.node_shape)
    u0s = np.asarray(bc1.free_mask) * 5.0
    u0 = np.stack([u0s, 2.0 * u0s], axis=-1)
    dt, n = 0.01, 12

    res2 = run_transient(K, M, mesh, bc2, np.zeros_like(u0), u0, dt, n,
                         vdim=2, config=CFG64)
    res1 = run_transient(Ks, ms, mesh, bc1, np.zeros_like(u0s), u0s, dt, n,
                         config=CFG64)
    np.testing.assert_allclose(res2.values[..., 0], res1.values,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(res2.values[..., 1], 2.0 * res1.values,
                               rtol=0, atol=1e-10)
