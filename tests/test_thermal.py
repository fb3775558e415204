"""Thermoelasticity tests (ADVICE r4: the alpha/delta_T/clamp_both surface
shipped untested).  Covers the verified identities:

* weak-form identity  b·u = β ∫ ΔT div(u) dx  for ``assemble_thermal_load``
  on a random nodal ΔT (exact for P1 — constant per-simplex gradients),
* 1D textbook bars: fixed-fixed σ = −EαΔT, fixed-free σ = 0 (both exact),
* 3D iso-invariance of von Mises (the isotropic subtraction is deviator-free
  ONLY in 3D) and 2D regression values against an independent in-test
  reimplementation (where the 2×2 convention makes iso matter),
* a clamp_both ND solve through the MG level_builder path,
* the clamp_both + end_load guard.
"""

import numpy as np
import pytest

from pde_solver.mesh import box_mesh, interval_mesh, rectangle_mesh
from pde_solver.ops import assembly
from pde_solver.ops.elements import subelem_geometry
from pde_solver.models.elasticity import (
    _vm_from_gradients, solve_bar_1d, solve_elasticity_nd,
    thermal_stress_coefficient)


def _integral_dT_div_u(mesh, dT, u):
    """Direct quadrature of β-free ∫ ΔT div(u) dx: per simplex, div(u) is
    constant (P1) and the exact average of the linear ΔT is its vertex
    mean, so ∫_K ΔT div(u) = |K| · mean(ΔT_vertices) · div(u)|_K."""
    d = mesh.dim
    total = 0.0
    dT_means = assembly.subelem_vertex_mean(mesh, dT)
    for t, sub in enumerate(mesh.subelems):
        geom = subelem_geometry(mesh, t, 0)
        div_u = np.zeros(mesh.cell_shape)
        for a, delta in enumerate(sub):
            region = tuple(slice(x, x + n)
                           for x, n in zip(delta, mesh.cell_shape))
            for i in range(d):
                div_u += u[region + (i,)] * geom.grads[a][i]
        total += geom.volume * float(np.sum(dT_means[t] * div_u))
    return total


@pytest.mark.parametrize("mesh", [
    rectangle_mesh(7, 5, (0.0, 0.0), (1.3, 0.8)),
    box_mesh(4, 3, 5, (0.0, 0.0, 0.0), (1.0, 0.7, 1.1)),
])
def test_thermal_load_weak_form_identity(mesh):
    rng = np.random.default_rng(7)
    d = mesh.dim
    beta = 3.7
    dT = rng.standard_normal(mesh.node_shape)
    u = rng.standard_normal(mesh.node_shape + (d,))
    b = assembly.assemble_thermal_load(mesh, beta, dT)
    lhs = float(np.sum(b * u))
    rhs = beta * _integral_dT_div_u(mesh, dT, u)
    assert abs(lhs - rhs) <= 1e-12 * max(abs(rhs), 1.0)


def test_thermal_load_uniform_matches_nodal():
    mesh = rectangle_mesh(6, 4, (0.0, 0.0), (1.0, 1.0))
    b_u = assembly.assemble_thermal_load(mesh, 2.0, 5.0)
    b_n = assembly.assemble_thermal_load(mesh, 2.0,
                                         np.full(mesh.node_shape, 5.0))
    assert np.allclose(b_u, b_n, atol=1e-13)


def test_bar_fixed_fixed_thermal_stress_exact():
    """Fully constrained bar heated by ΔT: σ = −E α ΔT everywhere, exactly."""
    E, alpha, dT = 70e9, 2.3e-5, 40.0
    x, sigma, info = solve_bar_1d(2.0, 64, E, 1e-4, 0.0, alpha=alpha,
                                  delta_T=dT, clamp_both=True)
    assert info["converged"]
    expected = -E * alpha * dT
    assert np.abs(sigma - expected).max() <= 1e-9 * abs(expected)


def test_bar_fixed_free_thermal_stress_free():
    """Unconstrained thermal expansion: stress-free (σ = 0 exactly) — this
    also witnesses load-side/stress-side ΔT̄ consistency (ADVICE r4: both
    must use the same per-element mean)."""
    E, alpha, dT = 70e9, 2.3e-5, 40.0
    x, sigma, info = solve_bar_1d(2.0, 64, E, 1e-4, 0.0, alpha=alpha,
                                  delta_T=dT, clamp_both=False)
    assert info["converged"]
    assert np.abs(sigma).max() <= 1e-9 * E * alpha * dT


def test_bar_clamp_both_end_load_raises():
    with pytest.raises(ValueError, match="end_load"):
        solve_bar_1d(1.0, 16, 70e9, 1e-4, 0.0, end_load=100.0,
                     clamp_both=True)


def test_vm_iso_invariant_in_3d_only():
    """The isotropic subtraction is deviator-free in 3D (vm unchanged);
    under the 2×2 convention it shifts the deviator by −(iso/3)I₂ and
    changes vm (ADVICE r4: the old docstring claimed otherwise)."""
    rng = np.random.default_rng(3)
    G3 = rng.standard_normal((4, 5, 3, 3))
    vm0, _ = _vm_from_gradients(G3, np, 3, 1.1e6, 0.7e6)
    vm1, _ = _vm_from_gradients(G3, np, 3, 1.1e6, 0.7e6, iso=2.5e5)
    assert np.allclose(vm0, vm1, rtol=1e-12)

    G2 = rng.standard_normal((4, 5, 2, 2))
    vm0_2d, _ = _vm_from_gradients(G2, np, 2, 1.1e6, 0.7e6)
    vm1_2d, _ = _vm_from_gradients(G2, np, 2, 1.1e6, 0.7e6, iso=2.5e5)
    assert np.abs(vm0_2d - vm1_2d).max() > 1e-3 * np.abs(vm0_2d).max()


@pytest.mark.parametrize("mode", ["plane_stress", "plane_strain"])
def test_vm_2d_regression_vs_independent(mode):
    """2D vm with iso vs an independent in-test reimplementation of
    σ = λ tr(ε) I + 2με − iso·I with the 1/3·tr deviator convention."""
    from pde_solver.models.elasticity import lame_parameters

    rng = np.random.default_rng(11)
    lam, mu = lame_parameters(210e9, 0.3, mode)
    G = rng.standard_normal((2, 6, 2, 2))
    iso = 1.7e8
    vm, _ = _vm_from_gradients(G, np, 2, lam, mu, iso=iso)

    eps = 0.5 * (G + np.swapaxes(G, -1, -2))
    tr = np.trace(eps, axis1=-2, axis2=-1)
    sig = lam * tr[..., None, None] * np.eye(2) + 2 * mu * eps \
        - iso * np.eye(2)
    s_dev = sig - (np.trace(sig, axis1=-2, axis2=-1) / 3.0)[..., None, None] \
        * np.eye(2)
    vm_ref = np.sqrt(1.5 * np.sum(s_dev ** 2, axis=(-2, -1)))
    assert np.allclose(vm, vm_ref, rtol=1e-12)


def _to_grid(flat_field, mesh):
    """Invert mesh.flatten_values (x-fastest flat order → node grid)."""
    v = np.asarray(flat_field).reshape(mesh.node_shape[::-1])
    return np.moveaxis(v, range(mesh.dim), range(mesh.dim)[::-1])


def test_clamp_both_nd_thermal_through_mg():
    """clamp_both 2D plane-strain thermal solve routed through the MG
    level_builder (the coarse levels must clamp BOTH faces too).  At the
    plate center the analytic constrained state holds: ε_xx = 0, σ_yy = 0
    → σ_xx = −βΔT·2μ/(λ+2μ), vm = sqrt(5/6)·|σ_xx| under the 2×2
    convention (end effects decay over ~one plate width)."""
    from pde_solver.config import config_overrides
    from pde_solver.models.elasticity import lame_parameters

    E, nu, alpha, dT = 210e9, 0.3, 1.2e-5, 50.0
    # long plate: the center is ~4 widths from either clamp, so the 1-D
    # constrained state holds there to O(h²)+Saint-Venant residue (~2.5%)
    mesh = rectangle_mesh(64, 8, (0.0, 0.0), (8.0, 1.0))
    with config_overrides(mg_threshold=100, host_direct_threshold=0):
        field, info = solve_elasticity_nd(
            mesh, E, nu, np.zeros(2), "plane_strain",
            thermal=(alpha, dT), clamp_both=True)
    assert info["converged"]
    vm = _to_grid(field, mesh)
    lam, mu = lame_parameters(E, nu, "plane_strain")
    beta = thermal_stress_coefficient(E, nu, alpha, "plane_strain")
    sig_xx = beta * dT * 2.0 * mu / (lam + 2.0 * mu)
    vm_center_expected = np.sqrt(5.0 / 6.0) * sig_xx
    center = vm[mesh.node_shape[0] // 2, mesh.node_shape[1] // 2]
    assert abs(center - vm_center_expected) < 0.05 * vm_center_expected


def test_thermal_3d_solve_iso_consistency():
    """3D: uniform ΔT, fixed-free → Saint-Venant decay: the free-end region
    must be nearly stress-free (far below βΔT), while the clamped face
    carries O(βΔT) constraint stress — witnessing that the thermal load
    and the iso stress correction are mutually consistent."""
    mesh = box_mesh(8, 6, 6, (0, 0, 0), (1.0, 0.6, 0.6))
    E, nu, alpha, dT = 210e9, 0.3, 1.2e-5, 30.0
    field, info = solve_elasticity_nd(mesh, E, nu, np.zeros(3), "3d",
                                      thermal=(alpha, dT))
    assert info["converged"]
    beta = thermal_stress_coefficient(E, nu, alpha, "3d")
    vm = _to_grid(field, mesh)
    assert vm[-1, 1:-1, 1:-1].max() < 0.05 * beta * dT  # free end
    assert vm[0].max() > 0.3 * beta * dT                # clamped face
