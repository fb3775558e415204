"""Sinusoidally driven transients (extension: the reference's sources and
boundary values are constants, fenics_mcp_server.py:304-318).

Validation: dense θ-stepping parity with time-dependent g(t)/b(t), the
classic semi-infinite thermal-wave solution (penetration depth √(2κ/ω)),
checkpoint/resume phase continuity (the step0 plumbing), sharded-scan
parity, and radial (curvilinear) driving through the mixed tool.
"""

import numpy as np
import pytest

from pde_solver.mesh import flatten_values, interval_mesh, rectangle_mesh
from pde_solver.models import heat
from pde_solver.models.heat import HeatProblem
from pde_solver.ops import assembly


def test_periodic_matches_dense_stepping():
    mesh = rectangle_mesh(6, 5, (0, 0), (1.0, 1.0))
    kappa, dt, nsteps, theta = 0.4, 0.02, 9, 1.0
    omega, phase, amp_bc, amp_src = 3.0, 0.4, 7.0, 2.5
    left = mesh.face_mask(0, 0)
    p = HeatProblem(mesh=mesh, diffusivity=kappa, T_initial=5.0,
                    dt=dt, num_steps=nsteps, theta=theta,
                    bc_pairs=[(left, 20.0)],
                    bc_amp_pairs=[(left, amp_bc)],
                    source_type="constant", source_value=1.0,
                    source_amp=amp_src, mod_omega=omega, mod_phase=phase)
    _, values, info = heat.solve_heat_problem(p)

    # independent dense stepping of the identical scheme
    K = {o: kappa * W for o, W in assembly.assemble_scalar_stencil(
        mesh, "stiffness").items()}
    A = assembly.stencil_to_dense(mesh, K)
    M = assembly.stencil_to_dense(
        mesh, assembly.assemble_scalar_stencil(mesh, "mass"))
    load = flatten_values(assembly.assemble_load(mesh), 2)
    from pde_solver.ops.bc import DirichletBC
    bc = DirichletBC.from_masks([(left, 20.0)], mesh.node_shape)
    free = flatten_values(np.asarray(bc.free_mask), 2).astype(bool)
    gflat = flatten_values(np.asarray(bc.values), 2)
    g_amp = flatten_values(np.where(left, amp_bc, 0.0), 2)
    u = np.where(free, 5.0, gflat)  # IC with BC applied at t=0
    lhs = M + theta * dt * A
    for n in range(nsteps):
        t_n = n * dt
        s_n, s_np1 = np.sin(omega * t_n + phase), \
            np.sin(omega * (t_n + dt) + phase)
        w = theta * s_np1 + (1 - theta) * s_n
        b_t = (1.0 + 0.0) * load + (amp_src * w) * load  # f0=1, amp
        g_t = gflat + s_np1 * g_amp
        rhs = M @ u - (1 - theta) * dt * (A @ u) + dt * b_t
        un = g_t.copy()
        un[free] = np.linalg.solve(
            lhs[np.ix_(free, free)],
            rhs[free] - lhs[np.ix_(free, ~free)] @ g_t[~free])
        u = un
    np.testing.assert_allclose(values[-1], u, rtol=2e-5, atol=1e-7)
    assert info["converged"]


def test_thermal_wave_analytic():
    # semi-infinite solid, surface T(0,t) = A sin(ωt): the quasi-steady
    # response is u = A e^{-kx} sin(ωt - kx) with k = sqrt(ω/2κ) — THE
    # textbook periodic-conduction solution (daily/annual ground cycles)
    kappa, omega, A = 1.0, 2.0 * np.pi, 10.0
    k = np.sqrt(omega / (2.0 * kappa))     # ≈ 1.772
    L, nx = 4.0, 512                       # ≈ 7 decay lengths
    period = 2.0 * np.pi / omega
    nper, steps_per = 4, 256
    dt = period / steps_per
    mesh = interval_mesh(nx, 0.0, L)
    p = HeatProblem(mesh=mesh, diffusivity=kappa, T_initial=0.0,
                    dt=dt, num_steps=nper * steps_per, theta=0.5,
                    bc_pairs=[(mesh.face_mask(0, 0), 0.0),
                              (mesh.face_mask(0, 1), 0.0)],
                    bc_amp_pairs=[(mesh.face_mask(0, 0), A)],
                    mod_omega=omega)
    times, values, info = heat.solve_heat_problem(p)
    x = mesh.flat_node_coords()[:, 0]
    t_f = times[-1]
    exact = A * np.exp(-k * x) * np.sin(omega * t_f - k * x)
    # after 4 periods the start-up transient has decayed; compare where the
    # wave lives (first ~2.5 decay lengths)
    zone = x < 2.5 / k
    err = np.max(np.abs(values[-1][zone] - exact[zone]))
    assert err < 0.05 * A, err
    # penetration depth: amplitude at k·x = 1 is ≈ A/e (sample a full
    # period of snapshots to estimate the local amplitude)
    per_idx = [i for i, t in enumerate(times)
               if t > t_f - period - 1e-12]
    j = int(np.argmin(np.abs(k * x - 1.0)))
    amp_j = 0.5 * (values[per_idx, j].max() - values[per_idx, j].min())
    np.testing.assert_allclose(amp_j, A * np.exp(-1.0), rtol=0.08)
    assert info["converged"]


def test_periodic_checkpoint_resume_phase(tmp_path):
    """Chunked (checkpointed) stepping must agree with the plain scan —
    the chunks enter the scan at nonzero step offsets, so this pins the
    step0/phase plumbing."""
    from pde_solver.config import config_overrides

    mesh = interval_mesh(24, 0.0, 1.0)
    common = dict(mesh=mesh, diffusivity=1.0, T_initial=0.0,
                  dt=0.01, num_steps=12, theta=1.0,
                  bc_pairs=[(mesh.face_mask(0, 0), 0.0),
                            (mesh.face_mask(0, 1), 0.0)],
                  bc_amp_pairs=[(mesh.face_mask(0, 0), 5.0)],
                  mod_omega=9.0, mod_phase=0.3)
    _, base, _ = heat.solve_heat_problem(HeatProblem(**common))
    with config_overrides(transient_checkpoint_every=5,
                          checkpoint_dir=str(tmp_path)):
        _, chunked, _ = heat.solve_heat_problem(HeatProblem(**common))
    np.testing.assert_allclose(chunked[-1], base[-1], rtol=1e-6,
                               atol=1e-9)


def test_periodic_sharded_supported():
    """Sinusoidal driving composes with the sharded scan (was a ValueError
    before round 4's continuation; full parity is asserted in
    tests/test_parallel.py::test_sharded_time_mod_matches_single_device)."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from pde_solver.config import config_overrides

    mesh = interval_mesh(15, 0.0, 1.0)
    p = HeatProblem(mesh=mesh, T_initial=0.0, dt=0.01, num_steps=3,
                    bc_pairs=[(mesh.face_mask(0, 0), 0.0)],
                    bc_amp_pairs=[(mesh.face_mask(0, 0), 1.0)],
                    mod_omega=1.0)
    _, ref_values, _ = heat.solve_heat_problem(p)
    with config_overrides(shard_devices=8):
        _, sh_values, _ = heat.solve_heat_problem(p)
    scale = max(np.abs(ref_values).max(), 1e-30)
    assert np.abs(sh_values - ref_values).max() < 1e-6 * scale


# ----------------------------------------------------------------------
# API + NL routing
# ----------------------------------------------------------------------

def test_mixed_tool_accepts_periodic_dirichlet(tmp_path):
    from pde_solver import api
    from pde_solver.fields import load_field
    period = 0.5
    res = api.solve_heat_1D_mixed(
        length=1.0, nx=64, dt=period / 50, num_steps=100,
        data_dir=str(tmp_path),
        boundary_conditions={
            "left": {"type": "dirichlet", "value": 20.0, "amplitude": 5.0,
                     "period": period},
            "right": {"type": "dirichlet", "value": 20.0}})
    f = load_field(res.data_file)
    v = f.values_array()
    # the boundary node oscillates around 20 with amplitude ~5
    left_trace = v[:, 0]
    assert left_trace.max() > 24.0 and left_trace.min() < 16.0
    assert abs(np.mean(left_trace[1:]) - 20.0) < 1.0
    assert f.meta["boundary_conditions"]["left"]["amplitude"] == 5.0


def test_rule_parse_periodic_boundary_and_e2e():
    import asyncio

    from pde_solver.agents.dispatcher_agent import DispatcherAgent
    from pde_solver.agents.parser_agent import rule_based_parse
    from pde_solver.schema import PDEParameters

    r = rule_based_parse(
        "1D heat in a 0.5 m concrete wall, right face at 20 C, the left "
        "surface temperature varies sinusoidally between 10 and 30 C with "
        "a period of 60 s")
    spec = r["bc_values"]["left"]
    assert spec["value"] == 20.0 and spec["amplitude"] == 10.0
    assert spec["period"] == 60.0
    assert r["steady"] is False

    d = DispatcherAgent()
    name, args = d.route(PDEParameters.from_dict(r))
    assert name == "solve_heat_1D_mixed"
    assert args["boundary_conditions"]["left"]["amplitude"] == 10.0
    res = asyncio.new_event_loop().run_until_complete(
        d.dispatch(PDEParameters.from_dict(r)))
    assert not res.get("error")

    # "daily temperature cycle" implies the 86400 s period
    r2 = rule_based_parse(
        "ground temperature under a daily cycle between -5 and 15 C at "
        "the top surface, 2 m deep domain")
    spec2 = r2["bc_values"]["top"]
    assert spec2["amplitude"] == 10.0 and spec2["period"] == 86400.0


def test_radial_mixed_periodic_dirichlet(tmp_path):
    """Radial (curvilinear) sinusoidal driving: a cylindrical annulus with a
    periodically driven outer surface and insulated inner face.  The outer
    node must trace the prescribed sinusoid exactly (Dirichlet), and the
    interior response must lag and attenuate (thermal-wave physics carried
    through the r-weighted assembly)."""
    from pde_solver import api
    from pde_solver.fields import load_field

    period, amp, base = 0.5, 5.0, 20.0
    res = api.solve_heat_radial_mixed(
        kind="cylinder", r_inner=0.5, r_outer=1.0, nr=96,
        diffusivity=0.05, T_initial=base, dt=period / 64, num_steps=256,
        data_dir=str(tmp_path),
        boundary_conditions={
            "outer": {"type": "dirichlet", "value": base, "amplitude": amp,
                      "period": period},
            "inner": {"type": "insulated"}})
    f = load_field(res.data_file)
    v = f.values_array()
    times = np.asarray(f.times)
    omega = 2.0 * np.pi / period
    # outer node: exactly the prescribed g(t) = base + amp·sin(ωt)
    np.testing.assert_allclose(v[1:, -1],
                               base + amp * np.sin(omega * times[1:]),
                               atol=1e-6)
    # interior attenuates: amplitude at mid-radius < at the surface
    last_period = times > times[-1] - period - 1e-12
    amp_mid = 0.5 * (v[last_period, 48].max() - v[last_period, 48].min())
    assert 0.0 < amp_mid < 0.8 * amp
    assert f.meta["boundary_conditions"]["outer"]["amplitude"] == amp
