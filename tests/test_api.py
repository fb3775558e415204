"""API surface tests: reference tool parity (signatures, defaults, artifacts,
metadata keys) for all 11 solver tools."""

import inspect

import numpy as np
import pytest

from pde_solver import api
from pde_solver.fields import SolveResult, load_field


# Reference tool signatures (name → ordered (param, default)) transcribed from
# /root/reference/fenics_mcp_server.py:1902-2761.
REF_SIGS = {
    "solve_heat_1D": [("length", 2.0), ("nx", 50), ("diffusivity", 1.0),
                      ("T_left", 20.0), ("T_right", 0.0), ("T_initial", 0.0),
                      ("dt", 0.01), ("num_steps", 50), ("data_dir", "data"),
                      ("steady", False), ("source_type", "none"), ("source_value", 0.0),
                      ("initial_type", "constant"), ("initial_amplitude", 1.0),
                      ("initial_wavenumber", 1.0)],
    "solve_heat_2D": [("Lx", 1.0), ("Ly", 1.0), ("nx", 30), ("ny", 30),
                      ("diffusivity", 1.0), ("T_boundary", 0.0), ("T_initial", 20.0),
                      ("dt", 0.01), ("num_steps", 50), ("data_dir", "data"),
                      ("steady", False), ("source_type", "none"), ("source_value", 0.0),
                      ("initial_type", "constant"), ("initial_amplitude", 1.0),
                      ("initial_wavenumber", 1.0)],
    "solve_heat_3D": [("Lx", 1.0), ("Ly", 1.0), ("Lz", 1.0), ("nx", 10), ("ny", 10),
                      ("nz", 10), ("diffusivity", 1.0), ("T_boundary", 0.0),
                      ("T_initial", 20.0), ("dt", 0.01), ("num_steps", 20),
                      ("data_dir", "data"), ("steady", False), ("source_type", "none"),
                      ("source_value", 0.0), ("initial_type", "constant"),
                      ("initial_amplitude", 1.0), ("initial_wavenumber", 1.0),
                      ("geometry_type", "box"), ("cylinder_radius", None),
                      ("T_left", None), ("T_right", None), ("T_side", None),
                      ("core_radius", None), ("core_diffusivity", None)],
    "solve_heat_3D_spherical": [("r_inner", 0.1), ("r_outer", 1.0), ("nr", 20),
                                ("ntheta", 20), ("nphi", 20), ("diffusivity", 1.0),
                                ("T_boundary", 20.0), ("T_initial", 20.0), ("dt", 0.01),
                                ("num_steps", 50), ("data_dir", "data"), ("steady", False),
                                ("source_type", "none"), ("source_value", 0.0),
                                ("initial_type", "constant"), ("initial_amplitude", 1.0)],
    "solve_heat_1D_cylindrical": [("r_inner", 0.1), ("r_outer", 1.0), ("nr", 50),
                                  ("diffusivity", 1.0), ("T_inner", 100.0),
                                  ("T_outer", 20.0), ("T_initial", 20.0), ("dt", 0.01),
                                  ("num_steps", 50), ("data_dir", "data"),
                                  ("steady", False), ("source_type", "none"),
                                  ("source_value", 0.0), ("initial_type", "constant"),
                                  ("initial_amplitude", 1.0)],
    "solve_heat_1D_spherical": [("r_inner", 0.1), ("r_outer", 1.0), ("nr", 50),
                                ("diffusivity", 1.0), ("T_inner", 100.0),
                                ("T_outer", 20.0), ("T_initial", 20.0), ("dt", 0.01),
                                ("num_steps", 50), ("data_dir", "data"),
                                ("steady", False), ("source_type", "none"),
                                ("source_value", 0.0), ("initial_type", "constant"),
                                ("initial_amplitude", 1.0)],
    "solve_heat_2D_cylindrical": [("r_inner", 0.1), ("r_outer", 1.0), ("z_length", 2.0),
                                  ("nr", 30), ("nz", 30), ("diffusivity", 1.0),
                                  ("T_boundary", 20.0), ("T_initial", 20.0), ("dt", 0.01),
                                  ("num_steps", 50), ("data_dir", "data"),
                                  ("steady", False), ("source_type", "none"),
                                  ("source_value", 0.0), ("initial_type", "constant"),
                                  ("initial_amplitude", 1.0)],
    "solve_heat_2D_spherical": [("r_inner", 0.1), ("r_outer", 1.0), ("nr", 30),
                                ("ntheta", 30), ("diffusivity", 1.0),
                                ("T_boundary", 20.0), ("T_initial", 20.0), ("dt", 0.01),
                                ("num_steps", 50), ("data_dir", "data"),
                                ("steady", False), ("source_type", "none"),
                                ("source_value", 0.0), ("initial_type", "constant"),
                                ("initial_amplitude", 1.0)],
    "solve_elasticity_1D_static": [("L", 1.0), ("nx", 50), ("E", 210e9), ("area", 1.0),
                                   ("body_force", 0.0), ("quantity", "stress"),
                                   ("data_dir", "data")],
    "solve_elasticity_2D_static": [("Lx", 1.0), ("Ly", 1.0), ("nx", 30), ("ny", 30),
                                   ("E", 210e9), ("nu", 0.3), ("body_fx", 0.0),
                                   ("body_fy", 0.0), ("quantity", "stress"),
                                   ("plane_stress", True), ("data_dir", "data")],
    "solve_elasticity_3D_static": [("Lx", 1.0), ("Ly", 1.0), ("Lz", 1.0), ("nx", 10),
                                   ("ny", 10), ("nz", 10), ("E", 210e9), ("nu", 0.3),
                                   ("body_fx", 0.0), ("body_fy", 0.0), ("body_fz", 0.0),
                                   ("quantity", "stress"), ("data_dir", "data")],
    # Plot tools (reference fenics_mcp_server.py:2764-2937, :3409-3421).
    "plot_time_series_field_from_file": [
        ("data_file", inspect.Parameter.empty), ("field_name", None),
        ("unit", None), ("output_dir", "plots"), ("filename", None)],
    "plot_time_series_field": [
        ("coords", inspect.Parameter.empty), ("values", inspect.Parameter.empty),
        ("times", inspect.Parameter.empty), ("dim", 1), ("field_name", "u"),
        ("unit", ""), ("output_dir", "plots"),
        ("filename", "field_timeseries_3d.html"), ("domain_bounds", None),
        ("geometry_type", None), ("geometry_params", None)],
}


@pytest.mark.parametrize("tool", sorted(REF_SIGS))
def test_tool_signatures_match_reference(tool):
    fn = getattr(api, tool)
    sig = inspect.signature(fn)
    got = [(name, p.default) for name, p in sig.parameters.items()]
    assert got == REF_SIGS[tool]


def _check_artifact(res, dim, name, tmp_path, expect_nt=None):
    assert isinstance(res, SolveResult)
    assert res.dim == dim
    field = load_field(res.data_file)
    coords = field.coords_array()
    values = field.values_array()
    assert coords.shape[1] == 3
    assert values.shape[1] == coords.shape[0]
    if expect_nt is not None:
        assert values.shape[0] == expect_nt
    assert field.meta["name"] == name
    assert "solver_stats" in field.meta
    assert field.meta["solver_stats"]["converged"]
    return field


def test_solve_heat_1d_artifact(tmp_path):
    res = api.solve_heat_1D(nx=16, num_steps=4, data_dir=str(tmp_path))
    f = _check_artifact(res, 1, "temperature", tmp_path, expect_nt=5)
    # 1D coords sorted ascending with y=z=0 (reference embeds [x,0,0])
    assert np.all(np.diff(f.coords_array()[:, 0]) > 0)
    assert np.allclose(f.coords_array()[:, 1:], 0.0)
    for key in ("unit", "pde", "coordinate_system", "length", "source_type",
                "source_value", "steady"):
        assert key in f.meta


def test_solve_heat_1d_steady_values(tmp_path):
    res = api.solve_heat_1D(nx=64, steady=True, data_dir=str(tmp_path))
    f = load_field(res.data_file)
    x = f.coords_array()[:, 0]
    assert np.allclose(f.values_array()[0], 20.0 * (1 - x / 2.0), atol=1e-8)


def test_solve_heat_2d_artifact(tmp_path):
    res = api.solve_heat_2D(nx=8, ny=8, num_steps=3, data_dir=str(tmp_path))
    f = _check_artifact(res, 2, "temperature", tmp_path, expect_nt=4)
    for key in ("Lx", "Ly"):
        assert key in f.meta
    # initial snapshot honors T_initial in the interior and BC on the boundary
    v0 = f.values_array()[0]
    assert v0.max() == pytest.approx(20.0)
    assert v0.min() == pytest.approx(0.0)


def test_solve_heat_3d_cylinder_composite(tmp_path):
    res = api.solve_heat_3D(nx=6, ny=6, nz=6, num_steps=2, data_dir=str(tmp_path),
                            geometry_type="cylinder", cylinder_radius=0.5,
                            T_left=80.0, T_right=10.0,
                            core_radius=0.25, core_diffusivity=10.0)
    f = _check_artifact(res, 3, "temperature", tmp_path, expect_nt=3)
    assert f.meta["geometry_type"] == "cylinder"
    assert f.meta["cylinder_radius"] == 0.5
    assert f.meta["T_left"] == 80.0 and f.meta["T_right"] == 10.0
    assert f.meta["core_radius"] == 0.25 and f.meta["base_diffusivity"] == 1.0
    # coords span the centered box embedding
    c = f.coords_array()
    assert c[:, 1].min() == pytest.approx(-0.5) and c[:, 1].max() == pytest.approx(0.5)


def test_solve_heat_mixed_artifacts(tmp_path):
    # 1D: Dirichlet left + Robin right, steady → exact linear profile
    res = api.solve_heat_1D_mixed(
        length=1.0, nx=32, steady=True, data_dir=str(tmp_path),
        boundary_conditions={
            "left": 100.0,
            "right": {"type": "robin", "h": 5.0, "T_ambient": 25.0}})
    f = _check_artifact(res, 1, "temperature", tmp_path, expect_nt=1)
    x = f.coords_array()[:, 0]
    c = 5.0 * (25.0 - 100.0) / (1.0 + 5.0)  # h(T∞−T0)/(1+hL/κ)
    assert np.allclose(f.values_array()[0], 100.0 + c * x, rtol=1e-8)
    assert f.meta["boundary_conditions"]["right"]["type"] == "robin"

    # 2D transient: convective cooling on all faces
    res = api.solve_heat_2D_mixed(
        nx=8, ny=8, num_steps=3, T_initial=90.0, data_dir=str(tmp_path),
        boundary_conditions={"all": {"type": "convection", "h": 4.0,
                                     "T_ambient": 20.0}})
    f = _check_artifact(res, 2, "temperature", tmp_path, expect_nt=4)
    v = f.values_array()
    assert v[-1].mean() < v[0].mean() and v[-1].min() > 19.0

    # 3D steady: flux in at left, convection out at right, insulated sides
    res = api.solve_heat_3D_mixed(
        nx=6, ny=4, nz=4, steady=True, data_dir=str(tmp_path),
        boundary_conditions={
            "left": {"type": "neumann", "flux": 30.0},
            "right": {"type": "robin", "h": 5.0, "T_ambient": 40.0},
            "sides": {"type": "insulated"}})
    f = _check_artifact(res, 3, "temperature", tmp_path, expect_nt=1)
    x = f.coords_array()[:, 0]
    uL = 40.0 + 30.0 / 5.0
    assert np.allclose(f.values_array()[0], uL + 30.0 * (1.0 - x), rtol=1e-6)


def test_solve_heat_curvilinear_tools(tmp_path):
    r1 = api.solve_heat_1D_cylindrical(nr=32, steady=True, data_dir=str(tmp_path))
    f1 = load_field(r1.data_file)
    assert f1.meta["geometry_type"] == "annulus"
    r = f1.coords_array()[:, 0]
    exact = 100.0 + (20.0 - 100.0) * np.log(r / 0.1) / np.log(1.0 / 0.1)
    assert np.max(np.abs(f1.values_array()[0] - exact)) < 0.15  # coarse O(h²)

    r2 = api.solve_heat_1D_spherical(nr=32, steady=True, data_dir=str(tmp_path))
    f2 = load_field(r2.data_file)
    assert f2.meta["geometry_type"] == "spherical_shell"

    r3 = api.solve_heat_2D_cylindrical(nr=8, nz=8, num_steps=2, data_dir=str(tmp_path))
    f3 = load_field(r3.data_file)
    assert f3.meta["coordinate_system"] == "cylindrical"
    assert f3.meta["z_length"] == 2.0
    # (r, z) → (r, 0, z) embedding
    assert np.allclose(f3.coords_array()[:, 1], 0.0)

    r4 = api.solve_heat_2D_spherical(nr=8, ntheta=8, num_steps=2, data_dir=str(tmp_path))
    f4 = load_field(r4.data_file)
    c4 = f4.coords_array()
    rr = np.sqrt(c4[:, 0] ** 2 + c4[:, 2] ** 2)
    assert rr.max() == pytest.approx(1.0)
    assert np.allclose(c4[:, 1], 0.0)

    r5 = api.solve_heat_3D_spherical(nr=6, ntheta=6, nphi=6, num_steps=2,
                                     data_dir=str(tmp_path))
    f5 = load_field(r5.data_file)
    c5 = f5.coords_array()
    rr5 = np.sqrt((c5 ** 2).sum(axis=1))
    assert rr5.max() == pytest.approx(1.0)
    assert rr5.min() == pytest.approx(0.1)


def test_solve_elasticity_tools(tmp_path):
    r1 = api.solve_elasticity_1D_static(L=2.0, nx=40, E=70e9, area=0.01,
                                        body_force=500.0, data_dir=str(tmp_path))
    f1 = _check_artifact(r1, 1, "axial_stress", tmp_path, expect_nt=1)
    assert f1.meta["unit"] == "Pa"
    x = f1.coords_array()[:, 0]
    exact = 500.0 * (2.0 - x) / 0.01
    assert np.max(np.abs(f1.values_array()[0][10:-10] - exact[10:-10])) < 1.0

    r2 = api.solve_elasticity_2D_static(nx=8, ny=8, body_fy=-7.65e4,
                                        data_dir=str(tmp_path))
    f2 = _check_artifact(r2, 2, "von_mises_stress", tmp_path, expect_nt=1)
    assert f2.meta["plane_stress"] is True
    assert np.all(f2.values_array()[0] >= -1e-6)

    r3 = api.solve_elasticity_3D_static(nx=5, ny=4, nz=4, body_fz=-7.65e4,
                                        quantity="strain", data_dir=str(tmp_path))
    f3 = _check_artifact(r3, 3, "von_mises_strain", tmp_path, expect_nt=1)
    assert f3.meta["unit"] == "-"


def test_solve_elasticity_3d_dynamic_tool(tmp_path):
    """Extension tool (beyond the reference): Newmark elastodynamics time
    series in the standard TimeSeriesField artifact shape."""
    r = api.solve_elasticity_3D_dynamic(
        Lx=1.0, Ly=0.25, Lz=0.25, nx=6, ny=3, nz=3, E=1e6, rho=10.0,
        body_fz=-98.1, dt=2e-3, num_steps=8, data_dir=str(tmp_path))
    f = _check_artifact(r, 3, "displacement_magnitude", tmp_path,
                        expect_nt=9)
    assert f.meta["integrator"] == "newmark_beta"
    vals = f.values_array()
    assert np.isfinite(vals).all() and vals.min() >= 0.0
    assert vals[0].max() == 0.0 and vals[-1].max() > 0.0  # motion happened
