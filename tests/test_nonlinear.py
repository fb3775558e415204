"""Nonlinear conductivity κ(T) = κ0(1+βT) via Picard iteration (extension —
the reference's solvers are linear-only).

Exact reference: the Kirchhoff transform θ = κ0(T + βT²/2) is harmonic, so
the steady 1D profile is the inverted quadratic of a straight line in θ.
"""

import numpy as np
import pytest

from pde_solver.mesh import interval_mesh, rectangle_mesh
from pde_solver.models import heat
from pde_solver.models.heat import HeatProblem, solve_heat_nonlinear


def _kirchhoff_T(theta, kappa0, beta):
    # solve κ0 (T + β T²/2) = θ for T (positive branch)
    return (-1.0 + np.sqrt(1.0 + 2.0 * beta * theta / kappa0)) / beta


def test_1d_kirchhoff_exact():
    kappa0, beta, L, T0, T1 = 2.0, 0.01, 1.0, 100.0, 0.0
    mesh = interval_mesh(256, 0.0, L)
    p = HeatProblem(mesh=mesh, steady=True, T_initial=50.0,
                    bc_pairs=[(mesh.face_mask(0, 0), T0),
                              (mesh.face_mask(0, 1), T1)])
    _, values, info = solve_heat_nonlinear(p, kappa0, beta)
    assert info["converged"] and info["picard_iterations"] < 40
    x = mesh.flat_node_coords()[:, 0]
    th0 = kappa0 * (T0 + beta * T0 ** 2 / 2)
    th1 = kappa0 * (T1 + beta * T1 ** 2 / 2)
    exact = _kirchhoff_T(th0 + (th1 - th0) * x / L, kappa0, beta)
    err = np.max(np.abs(values[0] - exact)) / max(abs(T0), abs(T1))
    assert err < 2e-4, err
    # the nonlinear profile must bow ABOVE the linear one (κ grows with T
    # → the hot side conducts better, flattening the hot-side gradient)
    linear = T0 + (T1 - T0) * x / L
    interior = (x > 0.1) & (x < 0.9)
    assert np.all(values[0][interior] > linear[interior])


def test_1d_beta_zero_matches_linear():
    mesh = interval_mesh(64, 0.0, 2.0)
    p = HeatProblem(mesh=mesh, steady=True,
                    bc_pairs=[(mesh.face_mask(0, 0), 30.0),
                              (mesh.face_mask(0, 1), 10.0)])
    _, values, info = solve_heat_nonlinear(p, 1.5, 1e-14)
    x = mesh.flat_node_coords()[:, 0]
    np.testing.assert_allclose(values[0], 30.0 - 10.0 * x, rtol=1e-8)
    assert info["picard_iterations"] <= 2


def test_2d_converges_and_bounded():
    mesh = rectangle_mesh(24, 24, (0, 0), (1.0, 1.0))
    p = HeatProblem(mesh=mesh, steady=True, T_initial=50.0,
                    bc_builder=lambda m: [(m.boundary_mask(), 0.0),
                                          (m.face_mask(0, 0), 100.0)])
    _, values, info = solve_heat_nonlinear(p, 1.0, 0.02)
    assert info["converged"]
    # maximum principle: no over/undershoot beyond the BC range
    assert values[0].min() >= -1e-8 and values[0].max() <= 100.0 + 1e-8


def test_negative_kappa_guard():
    mesh = interval_mesh(16, 0.0, 1.0)
    p = HeatProblem(mesh=mesh, steady=True, T_initial=100.0,
                    bc_pairs=[(mesh.face_mask(0, 0), 100.0),
                              (mesh.face_mask(0, 1), 0.0)])
    with pytest.raises(ValueError, match="non-positive"):
        solve_heat_nonlinear(p, 1.0, -0.5)  # κ(100) = 1·(1−50) < 0


# ----------------------------------------------------------------------
# API tool + NL routing
# ----------------------------------------------------------------------

def test_nonlinear_api_artifact(tmp_path):
    from pde_solver import api
    from pde_solver.fields import load_field
    res = api.solve_heat_1D_nonlinear(length=1.0, nx=64, kappa0=2.0,
                                      beta=0.01, T_left=100.0, T_right=0.0,
                                      data_dir=str(tmp_path))
    f = load_field(res.data_file)
    assert f.meta["nonlinear"] is True and f.meta["beta"] == 0.01
    x = f.coords_array()[:, 0]
    th0, th1 = 2.0 * (100 + 0.01 * 100 ** 2 / 2), 0.0
    exact = _kirchhoff_T(th0 + (th1 - th0) * x, 2.0, 0.01)
    np.testing.assert_allclose(f.values_array()[0], exact, atol=0.05)
    assert f.meta["solver_stats"]["converged"]

    res2 = api.solve_heat_2D_nonlinear(nx=16, ny=16, T_boundary=0.0,
                                       T_left=80.0, beta=0.02,
                                       data_dir=str(tmp_path))
    f2 = load_field(res2.data_file)
    assert f2.dim == 2 and f2.meta["solver_stats"]["converged"]


def test_nonlinear_nl_routing_and_e2e():
    import asyncio

    from pde_solver.agents.dispatcher_agent import DispatcherAgent
    from pde_solver.agents.parser_agent import rule_based_parse
    from pde_solver.schema import PDEParameters

    r = rule_based_parse(
        "steady heat in a 1 m rod whose conductivity increases with "
        "temperature, beta 0.02, left end at 100 C, right end at 0 C")
    assert "nonlinear_kappa" in r["notes"]
    assert r["material_params"]["beta"] == 0.02
    d = DispatcherAgent()
    name, args = d.route(PDEParameters.from_dict(r))
    assert name == "solve_heat_1D_nonlinear"
    assert args["beta"] == 0.02 and args["T_left"] == 100.0
    res = asyncio.new_event_loop().run_until_complete(
        d.dispatch(PDEParameters.from_dict(r)))
    assert not res.get("error")

    # transient phrasing keeps the linear route (nonlinear is steady-only)
    r2 = rule_based_parse(
        "transient heat in a 1 m rod with temperature-dependent "
        "conductivity, left at 100 C, 50 steps")
    name2, _ = d.route(PDEParameters.from_dict(r2))
    assert name2 == "solve_heat_1D"

    # "decreases with temperature" flips beta negative
    r3 = rule_based_parse(
        "steady heat in a rod whose conductivity decreases with "
        "temperature, left end at 50 C, right end at 0 C")
    assert r3["material_params"]["beta"] == -0.01
