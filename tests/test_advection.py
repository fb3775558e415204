"""Advection-diffusion family (extension: the reference parses
pde_type="advection" but has no solver for it).

Validation: convection-stencil structure (annihilates constants, discrete
integration-by-parts), dense IMEX stepping parity, and the analytic
advected-diffused Gaussian in 1D/2D.
"""

import numpy as np
import pytest

from pde_solver.mesh import interval_mesh, rectangle_mesh, flatten_values
from pde_solver.models.advection import (AdvectionProblem,
                                             solve_advection_problem)
from pde_solver.ops import assembly


def test_convection_stencil_annihilates_constants():
    # Σ_m C[n,m] = ∫ v·∇(Σφ_m) φ_n = 0 exactly (partition of unity)
    for mesh, v in [(interval_mesh(9, 0.0, 2.0), [1.3]),
                    (rectangle_mesh(6, 5, (0, 0), (1.0, 1.5)), [0.7, -0.4])]:
        C = assembly.assemble_convection_stencil(mesh, v)
        ones = np.ones(mesh.node_shape)
        out = assembly.stencil_to_dense(mesh, C) @ ones.reshape(-1)
        np.testing.assert_allclose(out, 0.0, atol=1e-13)


def test_convection_integration_by_parts():
    # ∫(v·∇u)w + ∫(v·∇w)u = ∮ (v·n) u w ds → C + Cᵀ acts only on boundary
    mesh = rectangle_mesh(7, 6, (0, 0), (1.0, 1.0))
    C = assembly.stencil_to_dense(
        mesh, assembly.assemble_convection_stencil(mesh, [0.9, 0.3]))
    S = C + C.T
    interior = ~flatten_values(mesh.boundary_mask(), 2)
    np.testing.assert_allclose(S[np.ix_(interior, interior)], 0.0,
                               atol=1e-13)


def test_imex_matches_dense_stepping():
    mesh = rectangle_mesh(6, 5, (0, 0), (1.0, 1.0))
    kappa, v, dt, nsteps, theta = 0.05, [0.8, -0.3], 0.01, 8, 1.0
    p = AdvectionProblem(mesh=mesh, velocity=v, diffusivity=kappa,
                         initial_type="gaussian", pulse_center=(0.4, 0.6),
                         pulse_width=0.15, dt=dt, num_steps=nsteps,
                         theta=theta, scheme="ab1")
    times, values, info = solve_advection_problem(p)
    assert info["scheme"] == "ab1"

    # independent dense IMEX: (M + θ dt K) u+ = (M − (1−θ)dt K − dt C) u
    K = {o: kappa * W for o, W in assembly.assemble_scalar_stencil(
        mesh, "stiffness").items()}
    A = assembly.stencil_to_dense(mesh, K)
    M = assembly.stencil_to_dense(
        mesh, assembly.assemble_scalar_stencil(mesh, "mass"))
    C = assembly.stencil_to_dense(
        mesh, assembly.assemble_convection_stencil(mesh, v))
    from pde_solver.models.advection import _initial_field
    from pde_solver.ops.bc import DirichletBC
    bc = DirichletBC.from_masks([(mesh.boundary_mask(), 0.0)],
                                mesh.node_shape)
    u = flatten_values(np.asarray(bc.apply_values(_initial_field(p))), 2)
    free = flatten_values(np.asarray(bc.free_mask), 2).astype(bool)
    lhs = M + theta * dt * A
    rhs_op = M - (1 - theta) * dt * A - dt * C
    # Dirichlet rows pinned (value 0): reduce to the free block
    for _ in range(nsteps):
        r = rhs_op @ u
        un = np.zeros_like(u)
        un[free] = np.linalg.solve(lhs[np.ix_(free, free)], r[free])
        u = un
    np.testing.assert_allclose(values[-1], u, rtol=2e-5, atol=1e-8)
    assert info["converged"]


def test_cnab2_matches_dense_stepping():
    # Independent dense CNAB2 recurrence with the AB1 bootstrap:
    #   (M + θ dt K) u+ = (M − (1−θ)dt K) u − dt(3/2 C u − 1/2 C u⁻)
    # with u⁻ seeded to u0 on the first step.
    mesh = rectangle_mesh(6, 5, (0, 0), (1.0, 1.0))
    kappa, v, dt, nsteps, theta = 0.05, [0.8, -0.3], 0.01, 8, 0.5
    p = AdvectionProblem(mesh=mesh, velocity=v, diffusivity=kappa,
                         initial_type="gaussian", pulse_center=(0.4, 0.6),
                         pulse_width=0.15, dt=dt, num_steps=nsteps)
    times, values, info = solve_advection_problem(p)
    assert info["scheme"] == "cnab2"

    K = {o: kappa * W for o, W in assembly.assemble_scalar_stencil(
        mesh, "stiffness").items()}
    A = assembly.stencil_to_dense(mesh, K)
    M = assembly.stencil_to_dense(
        mesh, assembly.assemble_scalar_stencil(mesh, "mass"))
    C = assembly.stencil_to_dense(
        mesh, assembly.assemble_convection_stencil(mesh, v))
    from pde_solver.models.advection import _initial_field
    from pde_solver.ops.bc import DirichletBC
    bc = DirichletBC.from_masks([(mesh.boundary_mask(), 0.0)],
                                mesh.node_shape)
    u = flatten_values(np.asarray(bc.apply_values(_initial_field(p))), 2)
    free = flatten_values(np.asarray(bc.free_mask), 2).astype(bool)
    lhs = M + theta * dt * A
    rhs_op = M - (1 - theta) * dt * A
    u_prev = u.copy()
    for _ in range(nsteps):
        r = rhs_op @ u - dt * (1.5 * (C @ u) - 0.5 * (C @ u_prev))
        un = np.zeros_like(u)
        un[free] = np.linalg.solve(lhs[np.ix_(free, free)], r[free])
        u_prev, u = u, un
    np.testing.assert_allclose(values[-1], u, rtol=2e-5, atol=1e-8)
    assert info["converged"]


def test_cnab2_second_order_in_dt():
    # dt self-convergence on a fixed mesh (removes the spatial floor): the
    # error vs a dt/8 reference must shrink ~4× when dt halves for CNAB2,
    # vs ~2× for the first-order AB1 fold.
    mesh = interval_mesh(128, 0.0, 3.0)
    kappa, v, s0, x0, T = 0.005, 1.0, 0.1, 0.7, 0.3

    def solve(nsteps, scheme):
        p = AdvectionProblem(mesh=mesh, velocity=[v], diffusivity=kappa,
                             initial_type="gaussian", pulse_center=[x0],
                             pulse_width=s0, dt=T / nsteps,
                             num_steps=nsteps, theta=0.5, scheme=scheme)
        _, values, info = solve_advection_problem(p)
        assert info["converged"]
        return values[-1]

    ref = solve(400, "cnab2")
    e1 = np.linalg.norm(solve(50, "cnab2") - ref)
    e2 = np.linalg.norm(solve(100, "cnab2") - ref)
    assert e2 < 0.32 * e1, (e1, e2)          # ~0.25 for O(Δt²)
    a1 = np.linalg.norm(solve(50, "ab1") - solve(400, "ab1"))
    a2 = np.linalg.norm(solve(100, "ab1") - solve(400, "ab1"))
    assert a2 > 0.38 * a1, (a1, a2)          # ~0.5 for O(Δt)
    # and CNAB2 is strictly more accurate than AB1 at the same dt
    assert e1 < a1


def test_gaussian_transport_1d_analytic():
    # free-space solution: amplitude/width evolve by diffusion while the
    # center advects: u = A0·s0/s(t) · exp(−(x−x0−vt)²/(2 s(t)²)),
    # s(t)² = s0² + 2κt.  Domain large enough that boundaries stay cold.
    # The IMEX splitting treats convection with explicit Euler → an O(Δt)
    # anti-diffusion v²Δt/2 (κ_eff = κ − v²Δt/2), so the error bound is
    # Δt-dominated and must shrink ~linearly when Δt halves.
    kappa, v, s0, x0 = 0.005, 1.0, 0.08, 0.7
    T = 0.6
    mesh = interval_mesh(512, 0.0, 3.0)
    x = mesh.flat_node_coords()[:, 0]
    s2 = s0 ** 2 + 2 * kappa * T
    exact = (s0 / np.sqrt(s2)) * np.exp(-(x - x0 - v * T) ** 2 / (2 * s2))

    def err_at(nsteps):
        p = AdvectionProblem(mesh=mesh, velocity=[v], diffusivity=kappa,
                             initial_type="gaussian", pulse_center=[x0],
                             pulse_width=s0, dt=T / nsteps,
                             num_steps=nsteps, theta=0.5, scheme="ab1")
        _, values, info = solve_advection_problem(p)
        assert info["cfl"] < 1.0 and info["converged"]
        peak = x[np.argmax(values[-1])]
        assert abs(peak - (x0 + v * T)) < 0.02
        return np.linalg.norm(values[-1] - exact) / np.linalg.norm(exact)

    e1, e2 = err_at(600), err_at(1200)
    assert e1 < 0.03, e1
    # first-order in Δt: halving dt must roughly halve the error
    assert e2 < 0.65 * e1, (e1, e2)


def test_gaussian_transport_2d_peak_moves():
    mesh = rectangle_mesh(96, 96, (0, 0), (2.0, 2.0))
    vx, vy, T = 0.8, 0.4, 0.5
    p = AdvectionProblem(mesh=mesh, velocity=[vx, vy], diffusivity=0.01,
                         initial_type="gaussian", pulse_center=(0.5, 0.7),
                         pulse_width=0.1, dt=0.005, num_steps=100,
                         theta=0.5)
    _, values, info = solve_advection_problem(p)
    coords = mesh.flat_node_coords()
    peak = coords[np.argmax(values[-1])]
    np.testing.assert_allclose(peak, [0.5 + vx * T, 0.7 + vy * T],
                               atol=0.06)
    # mass decays only through diffusion to the (cold) boundary: bounded
    assert values[-1].max() < values[0].max()
    assert info["converged"]


def test_stability_diagnostics_reported():
    # the package logger sets propagate=False, so assert through the info
    # dict (the user-facing channel) rather than caplog
    mesh = interval_mesh(64, 0.0, 1.0)
    p = AdvectionProblem(mesh=mesh, velocity=[50.0], diffusivity=0.001,
                         initial_type="gaussian", dt=0.01, num_steps=2)
    _, _, info = solve_advection_problem(p)
    assert info["cfl"] > 1.0
    assert info["cell_peclet"] > 2.0


# ----------------------------------------------------------------------
# API tools + NL routing
# ----------------------------------------------------------------------

def test_advection_api_artifacts(tmp_path):
    from pde_solver import api
    from pde_solver.fields import load_field
    res = api.solve_advection_1D(length=2.0, nx=128, velocity=1.0,
                                 diffusivity=0.01, num_steps=40,
                                 data_dir=str(tmp_path))
    f = load_field(res.data_file)
    assert f.meta["pde"] == "advection" and f.meta["velocity"] == [1.0]
    v = f.values_array()
    assert v.shape[0] == 41
    x = f.coords_array()[:, 0]
    # pulse starts centered and drifts downstream
    assert x[np.argmax(v[-1])] > x[np.argmax(v[0])]
    assert f.meta["solver_stats"]["converged"]

    res2 = api.solve_advection_2D(nx=24, ny=24, vx=0.5, vy=0.5,
                                  num_steps=20, data_dir=str(tmp_path))
    f2 = load_field(res2.data_file)
    assert f2.dim == 2 and f2.values_array().shape[0] == 21

    res3 = api.solve_advection_3D(nx=8, ny=8, nz=8, num_steps=5,
                                  data_dir=str(tmp_path))
    f3 = load_field(res3.data_file)
    assert f3.dim == 3 and np.isfinite(f3.values_array()).all()


def test_advection_nl_routing_and_e2e():
    import asyncio

    from pde_solver.agents.dispatcher_agent import DispatcherAgent
    from pde_solver.agents.parser_agent import (PDEParserAgent,
                                                    rule_based_parse)
    from pde_solver.schema import PDEParameters

    r = rule_based_parse(
        "simulate pollutant transport in a 2 m channel with flow speed "
        "1.5 m/s and diffusivity 0.02")
    assert r["pde_type"] == "advection"
    assert r["material_params"]["velocity"] == 1.5
    assert r["diffusivity"] == 0.02
    d = DispatcherAgent()
    name, args = d.route(PDEParameters.from_dict(r))
    assert name == "solve_advection_1D"
    assert args["velocity"] == 1.5 and args["diffusivity"] == 0.02
    assert args["dt"] * 1.5 <= 0.4 * args["length"] / args["nx"] + 1e-12

    r2 = rule_based_parse(
        "advection-diffusion of a tracer in a 1 m x 1 m domain with "
        "velocity (1.0, 0.5)")
    name2, args2 = d.route(PDEParameters.from_dict(r2))
    assert name2 == "solve_advection_2D"
    assert args2["vx"] == 1.0 and args2["vy"] == 0.5

    # end-to-end through the dispatcher (solve + plot artifact)
    p = PDEParserAgent().parse(
        "transport of a dye pulse in a 2 m channel, flow speed 1 m/s, "
        "diffusivity 0.01, 30 steps")
    name3, _ = d.route(p)
    assert name3 == "solve_advection_1D"
    res = asyncio.new_event_loop().run_until_complete(d.dispatch(p))
    assert not res.get("error")
    import os
    assert os.path.exists(res["html_path"])


def test_sharded_advection_matches_single_device():
    """The convection fold lands in B_list before the shard branch, so the
    domain-decomposed scan must reproduce the unsharded trajectory."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from pde_solver.config import config_overrides

    mesh = rectangle_mesh(15, 6, (0, 0), (2.0, 1.0))  # 16 x-planes / 8 dev
    p = AdvectionProblem(mesh=mesh, velocity=[0.9, 0.2], diffusivity=0.02,
                         initial_type="gaussian", pulse_center=(0.6, 0.5),
                         pulse_width=0.15, dt=0.01, num_steps=6, theta=1.0)
    _, base, _ = solve_advection_problem(p)
    with config_overrides(shard_devices=8):
        _, sharded, info = solve_advection_problem(p)
    np.testing.assert_allclose(sharded, base, rtol=2e-5, atol=1e-7)
    assert info["converged"]
