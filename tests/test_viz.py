"""Visualization tests: resampler correctness, routing cascade, HTML output."""

import json
import re

import numpy as np
import pytest

from pde_solver import api
from pde_solver.viz.resample import FieldResampler, detect_structured_grid
from pde_solver.viz.plots import plot_time_series_field, plot_time_series_field_from_file


def test_detect_structured_grid():
    x, y = np.meshgrid(np.linspace(0, 1, 5), np.linspace(0, 2, 4), indexing="ij")
    pts = np.column_stack([x.flatten(), y.flatten()])
    rng = np.random.default_rng(0)
    pts_shuffled = pts[rng.permutation(len(pts))]
    res = detect_structured_grid(pts_shuffled)
    assert res is not None
    scattered = rng.standard_normal((20, 2))
    assert detect_structured_grid(scattered) is None


def test_resampler_structured_exact_on_linear_field():
    x, y = np.meshgrid(np.linspace(0, 1, 9), np.linspace(0, 1, 7), indexing="ij")
    pts = np.column_stack([x.flatten(), y.flatten()])
    vals = (2 * pts[:, 0] + 3 * pts[:, 1])[None, :]
    rs = FieldResampler(pts)
    q = np.array([[0.25, 0.5], [0.111, 0.9], [0.77, 0.33]])
    out = rs(vals, q)
    assert np.allclose(out[0], 2 * q[:, 0] + 3 * q[:, 1], atol=1e-12)


def test_resampler_scattered_matches_griddata():
    from scipy.interpolate import griddata
    rng = np.random.default_rng(1)
    pts = rng.random((60, 2))
    vals = np.sin(pts[:, 0] * 3) + pts[:, 1] ** 2
    q = rng.random((25, 2)) * 0.8 + 0.1
    rs = FieldResampler(pts)
    mine = rs(vals, q)
    gold = griddata(pts, vals, q, method="linear")
    ok = ~np.isnan(gold)
    assert np.allclose(mine[ok], gold[ok], atol=1e-10)


def _read_fig(html_path):
    with open(html_path) as f:
        html = f.read()
    assert "Plotly.newPlot" in html
    assert "cdn.plot.ly" in html
    m = re.search(r"var fig = (\{.*?\});\nvar config", html, re.S)
    assert m, "figure JSON not found in HTML"
    return json.loads(m.group(1)), html


def test_plot_1d_line_html(tmp_path):
    res = api.solve_heat_1D(nx=12, num_steps=3, data_dir=str(tmp_path))
    pr = plot_time_series_field_from_file(res.data_file, output_dir=str(tmp_path / "plots"))
    fig, html = _read_fig(pr.html_path)
    assert fig["data"][0]["type"] == "scatter"
    assert len(fig["frames"]) == 4
    assert fig["layout"]["sliders"][0]["steps"][0]["label"] == "0.000"
    assert fig["layout"]["xaxis"]["range"] == [0.0, 2.0]


def test_plot_2d_surface_html(tmp_path):
    res = api.solve_heat_2D(nx=6, ny=5, num_steps=2, data_dir=str(tmp_path))
    pr = plot_time_series_field_from_file(res.data_file, output_dir=str(tmp_path / "plots"))
    fig, _ = _read_fig(pr.html_path)
    assert fig["data"][0]["type"] == "surface"
    assert len(fig["frames"]) == 3
    # aspect policy: square domain → x=y=1, z=0.6
    ar = fig["layout"]["scene"]["aspectratio"]
    assert ar == {"x": 1.0, "y": 1.0, "z": 0.6}


def test_plot_3d_box_volume_html(tmp_path):
    res = api.solve_heat_3D(nx=4, ny=4, nz=4, num_steps=2, data_dir=str(tmp_path))
    pr = plot_time_series_field_from_file(res.data_file, output_dir=str(tmp_path / "plots"))
    fig, _ = _read_fig(pr.html_path)
    assert fig["data"][0]["type"] == "volume"
    assert fig["layout"]["scene"]["aspectmode"] == "data"


def test_plot_3d_cylinder_routing(tmp_path):
    res = api.solve_heat_3D(nx=5, ny=6, nz=6, num_steps=2, geometry_type="cylinder",
                            cylinder_radius=0.5, T_left=80.0, T_right=10.0,
                            data_dir=str(tmp_path))
    pr = plot_time_series_field_from_file(res.data_file, output_dir=str(tmp_path / "plots"))
    fig, _ = _read_fig(pr.html_path)
    # specialized cylindrical plotter: 20×15×15 grid = 4500 points
    assert fig["data"][0]["type"] == "volume"
    assert len(fig["data"][0]["x"]) == 20 * 15 * 15
    assert "cylindrical" in fig["layout"]["title"]


def test_plot_3d_sphere_routing(tmp_path):
    res = api.solve_heat_3D_spherical(nr=5, ntheta=5, nphi=6, num_steps=2,
                                      data_dir=str(tmp_path))
    pr = plot_time_series_field_from_file(res.data_file, output_dir=str(tmp_path / "plots"))
    fig, _ = _read_fig(pr.html_path)
    assert fig["data"][0]["type"] == "volume"
    assert len(fig["data"][0]["x"]) == 15 ** 3
    assert "spherical" in fig["layout"]["title"]


def test_plot_frame_cap_30_for_3d(tmp_path):
    res = api.solve_heat_3D(nx=3, ny=3, nz=3, num_steps=40, data_dir=str(tmp_path))
    pr = plot_time_series_field_from_file(res.data_file, output_dir=str(tmp_path / "plots"))
    fig, _ = _read_fig(pr.html_path)
    assert len(fig["frames"]) == 30


def test_plot_raw_arrays_validation():
    with pytest.raises(ValueError):
        plot_time_series_field(coords=[[0, 0, 0]], values=[[1.0], [2.0]],
                               times=[0.0], dim=1)
    with pytest.raises(ValueError):
        plot_time_series_field(coords=[[0, 0]], values=[[1.0]], times=[0.0], dim=1)


def test_plot_elasticity_field_names(tmp_path):
    res = api.solve_elasticity_2D_static(nx=5, ny=5, body_fy=-1e4,
                                         data_dir=str(tmp_path))
    pr = plot_time_series_field_from_file(res.data_file, output_dir=str(tmp_path / "plots"))
    fig, _ = _read_fig(pr.html_path)
    assert "von_mises_stress" in fig["layout"]["title"]


def test_axisymmetric_2d_fields_plot_without_qhull_error(tmp_path):
    """2D curvilinear fields embed as (r, 0, z) / (r sinθ, 0, r cosθ) —
    the plotter must pick the SPANNING coordinate columns (the reference
    feeds columns (0,1) to griddata and dies with a QhullError on every
    axisymmetric field; fenics_mcp_server.py:3781)."""
    from pde_solver import api

    r = api.solve_heat_2D_cylindrical(r_inner=0.05, r_outer=0.07,
                                      z_length=0.07, nr=8, nz=8, steady=True,
                                      T_boundary=20.0,
                                      data_dir=str(tmp_path))
    p = api.plot_time_series_field_from_file(r.data_file,
                                             output_dir=str(tmp_path))
    html = open(p.html_path).read()
    assert "Plotly.newPlot" in html
    # axis labels follow the spanning columns (x=r, z)
    assert '"xaxis_title": "x (m)"' in html and '"yaxis_title": "z (m)"' in html

    r2 = api.solve_heat_2D_spherical(nr=8, ntheta=8, steady=True,
                                     data_dir=str(tmp_path))
    p2 = api.plot_time_series_field_from_file(r2.data_file,
                                              output_dir=str(tmp_path))
    assert "Plotly.newPlot" in open(p2.html_path).read()
