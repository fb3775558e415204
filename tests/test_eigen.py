"""Modal analysis: generalized eigenpairs K φ = λ M φ (extension — the
reference is static/transient only).

Exact references: the unit-square Dirichlet Laplacian spectrum
λ = π²(m²+n²) (with a degenerate pair), the fixed-free axial bar
ω_n = (2n−1)πc/(2L), and dense scipy.eigh cross-checks.
"""

import numpy as np
import pytest

from pde_solver.mesh import box_mesh, interval_mesh, rectangle_mesh
from pde_solver.ops import assembly
from pde_solver.ops.bc import DirichletBC
from pde_solver.ops.eigen import smallest_modes


def test_laplacian_square_spectrum():
    # π²(m²+n²): 2π², 5π² (×2 degenerate), 8π² — discrete values match to
    # O(h²); validated against the dense generalized eig of the SAME
    # discretization, so the assertion against the continuum is loose and
    # the assertion against scipy is tight
    mesh = rectangle_mesh(24, 24, (0, 0), (1.0, 1.0))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    bc = DirichletBC.from_masks([(mesh.boundary_mask(), 0.0)],
                                mesh.node_shape)
    lams, modes, info = smallest_modes(K, M, mesh, bc, num_modes=4)
    assert info["converged"]
    pi2 = np.pi ** 2
    np.testing.assert_allclose(lams, [2 * pi2, 5 * pi2, 5 * pi2, 8 * pi2],
                               rtol=2e-2)
    # dense cross-check (exactly the same discrete operator)
    from scipy.linalg import eigh
    A = assembly.stencil_to_dense(mesh, K)
    B = assembly.stencil_to_dense(mesh, M)
    from pde_solver.mesh import flatten_values
    free = flatten_values(np.asarray(bc.free_mask), 2).astype(bool)
    w = eigh(A[np.ix_(free, free)], B[np.ix_(free, free)],
             eigvals_only=True, subset_by_index=[0, 3])
    np.testing.assert_allclose(lams, w, rtol=1e-6)
    # M-orthonormality of the returned block
    for i in range(4):
        Mi = assembly.stencil_to_dense(mesh, M) @ flatten_values(
            modes[i], 2)
        for j in range(4):
            dot = flatten_values(modes[j], 2) @ Mi
            np.testing.assert_allclose(dot, 1.0 if i == j else 0.0,
                                       atol=1e-7)


def test_axial_bar_frequencies():
    # fixed-free bar: ω_n = (2n−1)πc/(2L), c = sqrt(E/ρ).  K = EA u'u',
    # M = ρA u u → λ = ω².
    E, rho, A_cs, L = 200e9, 7800.0, 1.0, 2.0
    c = np.sqrt(E / rho)
    mesh = interval_mesh(256, 0.0, L)
    K = {o: E * A_cs * W for o, W in assembly.assemble_scalar_stencil(
        mesh, "stiffness").items()}
    M = {o: rho * A_cs * W for o, W in assembly.assemble_scalar_stencil(
        mesh, "mass").items()}
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape)
    lams, _, info = smallest_modes(K, M, mesh, bc, num_modes=3)
    assert info["converged"]
    exact = np.array([(2 * n - 1) * np.pi * c / (2 * L)
                      for n in (1, 2, 3)]) ** 2
    np.testing.assert_allclose(lams, exact, rtol=1e-3)


def test_elasticity_modes_match_dense():
    # 3D clamped box, vector P1: subspace iteration must match dense eigh
    # of the same discrete pencil (small mesh)
    from pde_solver.mesh import flatten_values
    from pde_solver.models.elasticity import (assemble_vector_mass,
                                                  lame_parameters)
    from scipy.linalg import eigh

    E, nu, rho = 10e9, 0.3, 2000.0
    lam_p, mu = lame_parameters(E, nu, "3d")
    mesh = box_mesh(6, 3, 3, (0, 0, 0), (1.0, 0.4, 0.4))
    K = assembly.assemble_elasticity_stencil(mesh, lam_p, mu)
    M = assemble_vector_mass(mesh, rho)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=3)
    lams, modes, info = smallest_modes(K, M, mesh, bc, num_modes=4, vdim=3)
    assert info["converged"]
    A = assembly.stencil_to_dense(mesh, K, vdim=3)
    B = assembly.stencil_to_dense(mesh, M, vdim=3)
    free = flatten_values(np.asarray(bc.free_mask), 3).reshape(-1).astype(bool)
    w = eigh(A[np.ix_(free, free)], B[np.ix_(free, free)],
             eigvals_only=True, subset_by_index=[0, 3])
    np.testing.assert_allclose(lams, w, rtol=1e-6)
    # a slender-ish box clamped at one end: the two lowest modes are the
    # bending pair in y and z — only roughly degenerate on a coarse mesh
    # because the Freudenthal tet split is NOT symmetric under y↔z swap
    np.testing.assert_allclose(lams[0], lams[1], rtol=0.25)
    assert np.isfinite(modes).all()


# ----------------------------------------------------------------------
# API tool + NL routing
# ----------------------------------------------------------------------

def test_modal_api_artifact(tmp_path):
    from pde_solver import api
    from pde_solver.fields import load_field
    res = api.solve_elasticity_3D_modal(nx=8, ny=4, nz=4, num_modes=3,
                                        data_dir=str(tmp_path))
    f = load_field(res.data_file)
    freqs = f.meta["frequencies_hz"]
    assert len(freqs) == 3 and all(freqs[i] <= freqs[i + 1] + 1e-9
                                   for i in range(2))
    v = f.values_array()
    assert v.shape[0] == 3
    # mode shapes are unit-max normalized and clamped at x=0
    assert np.allclose(v.max(axis=1), 1.0)
    x = f.coords_array()[:, 0]
    assert np.allclose(v[:, x == 0.0], 0.0, atol=1e-12)
    assert f.meta["solver_stats"]["converged"]


def test_modal_nl_routing_and_e2e():
    import asyncio

    from pde_solver.agents.dispatcher_agent import DispatcherAgent
    from pde_solver.agents.parser_agent import rule_based_parse
    from pde_solver.schema import PDEParameters

    r = rule_based_parse(
        "compute the first 3 natural frequencies of a 1 m x 0.2 m x 0.2 m "
        "steel beam, E 210 GPa, density 7800")
    assert r["pde_type"] == "elasticity"
    assert "modal" in r["notes"] and "dynamic" not in r["notes"]
    assert r["material_params"]["num_modes"] == 3
    d = DispatcherAgent()
    name, args = d.route(PDEParameters.from_dict(r))
    assert name == "solve_elasticity_3D_modal"
    assert args["num_modes"] == 3 and args["E"] == 210e9
    assert args["Lx"] == 1.0 and args["Ly"] == 0.2

    res = asyncio.new_event_loop().run_until_complete(
        d.dispatch(PDEParameters.from_dict(r)))
    assert not res.get("error")
    import os
    assert os.path.exists(res["html_path"])

    # plain vibration phrasing still routes to elastodynamics
    r2 = rule_based_parse("simulate the vibration of a 1 m steel "
                          "cantilever in 3d, 20 steps")
    assert "dynamic" in r2["notes"] and "modal" not in r2.get("notes", [])


def test_modal_2d_api_and_routing(tmp_path):
    from pde_solver import api
    from pde_solver.agents.dispatcher_agent import DispatcherAgent
    from pde_solver.agents.parser_agent import rule_based_parse
    from pde_solver.fields import load_field
    from pde_solver.schema import PDEParameters

    res = api.solve_elasticity_2D_modal(nx=12, ny=4, num_modes=2,
                                        data_dir=str(tmp_path))
    f = load_field(res.data_file)
    assert len(f.meta["frequencies_hz"]) == 2 and f.dim == 2
    assert f.meta["solver_stats"]["converged"]

    r = rule_based_parse("modal analysis of a 2D plate 1 m x 0.2 m, "
                         "plane strain, first 2 modes")
    r["dim"] = 2
    d = DispatcherAgent()
    name, args = d.route(PDEParameters.from_dict(r))
    assert name == "solve_elasticity_2D_modal"
    assert args["num_modes"] == 2 and args["plane_stress"] is False
