"""Surface loads for elasticity (extension beyond the reference's
body-force-only loading, fenics_mcp_server.py:1670-1674, :1820-1824).

Key exactness facts used:
* 1D end load: u = P x/(EA), σ = P/A — linear, so P1 is exact.
* ν = 0 axial traction on the free end of a clamped strip/box: the exact
  solution u = (t/E) x, v = w = 0 satisfies every BC and is linear, so the
  FEM von Mises field must equal |t| everywhere to solver tolerance.
"""

import numpy as np
import pytest

from pde_solver import api
from pde_solver.fields import load_field


def test_bar_end_load_exact_stress():
    P, A, E, L = 5000.0, 0.01, 200e9, 2.0
    res = api.solve_elasticity_1D_loaded(L=L, nx=40, E=E, area=A,
                                         end_load=P)
    f = load_field(res.data_file)
    sigma = f.values_array()[0]
    np.testing.assert_allclose(sigma, P / A, rtol=1e-8)
    assert f.meta["end_load"] == P


def test_bar_end_load_plus_body_force():
    # -(EA u')' = f with EA u'(L) = P:  σ(x) = P/A + f (L-x)/A — linear in
    # x, exact for P1 (the reference's σ = f(L-x)/A case plus the end term)
    P, A, E, L, fb = 1000.0, 0.02, 70e9, 1.5, 300.0
    res = api.solve_elasticity_1D_loaded(L=L, nx=32, E=E, area=A,
                                         end_load=P, body_force=fb)
    f = load_field(res.data_file)
    x = f.coords_array()[:, 0]
    # The DG0→P1 consistent projection of a linear stress carries an
    # endpoint offset decaying inward at ratio 2+√3 (the same behavior
    # FEniCS project() produces — the parity behavior): interior nodes are
    # within ~1e-3, the middle third is machine-exact.
    exact = (P + fb * (L - x)) / A
    v = f.values_array()[0]
    np.testing.assert_allclose(v[1:-1], exact[1:-1], rtol=2e-3)
    mid = slice(len(x) // 3, 2 * len(x) // 3)
    np.testing.assert_allclose(v[mid], exact[mid], rtol=1e-8)


@pytest.mark.parametrize("dim", [2, 3])
def test_axial_traction_nu0_uniform_vm(dim):
    t = 2.5e6  # N/m² axial pull on the free end
    kw = dict(E=100e9, nu=0.0,
              loads={"right": {"type": "traction",
                               "vector": [t] + [0.0] * (dim - 1)}})
    if dim == 2:
        res = api.solve_elasticity_2D_loaded(Lx=2.0, Ly=0.5, nx=16, ny=8,
                                             **kw)
    else:
        res = api.solve_elasticity_3D_loaded(Lx=2.0, Ly=0.4, Lz=0.4,
                                             nx=10, ny=5, nz=5, **kw)
    f = load_field(res.data_file)
    vm = f.values_array()[0]
    # 2D: the reference's von Mises formula (fenics_mcp_server.py:1694-1711)
    # takes the 3D 1/3-trace deviator but sums only in-plane components →
    # uniaxial vm = sqrt(5/6)·t; 3D is the conventional vm = t.  We
    # reproduce the reference formula exactly (parity contract).
    expect = t * (np.sqrt(5.0 / 6.0) if dim == 2 else 1.0)
    np.testing.assert_allclose(vm, expect, rtol=1e-5)
    assert f.meta["loads"]["right"]["type"] == "traction"


def test_force_spec_divides_by_face_area():
    # total force F on the end face of a 0.5 x 0.4 cross-section → the
    # ν=0 uniform state has vm = F / (Ly·Lz)
    F = 1.0e5
    res = api.solve_elasticity_3D_loaded(
        Lx=1.0, Ly=0.5, Lz=0.4, nx=8, ny=4, nz=4, E=50e9, nu=0.0,
        loads={"right": {"type": "force", "vector": [F, 0.0, 0.0]}})
    f = load_field(res.data_file)
    np.testing.assert_allclose(f.values_array()[0], F / (0.5 * 0.4),
                               rtol=1e-5)


def test_pressure_spec_is_inward_normal():
    # pressure p on the right (+x) face → traction −p e_x (compression):
    # ν=0 uniform state, vm = p
    p = 3.0e5
    res = api.solve_elasticity_2D_loaded(
        Lx=1.0, Ly=0.3, nx=10, ny=4, E=10e9, nu=0.0,
        loads={"right": {"type": "pressure", "value": p}})
    f = load_field(res.data_file)
    # sqrt(5/6): the reference's 2D von Mises formula (see above)
    np.testing.assert_allclose(f.values_array()[0],
                               p * np.sqrt(5.0 / 6.0), rtol=1e-5)


def test_bending_load_sanity():
    # downward end load on a slender cantilever: von Mises must peak at
    # the clamped end (bending) and be ~linear along x away from the ends
    res = api.solve_elasticity_2D_loaded(
        Lx=2.0, Ly=0.2, nx=40, ny=6, E=200e9, nu=0.3,
        loads={"right": {"type": "force", "vector": [0.0, -1000.0]}})
    f = load_field(res.data_file)
    vm = f.values_array()[0]
    x = f.coords_array()[:, 0]
    # stress near the clamp dominates the tip region
    assert vm[x < 0.3].max() > 3.0 * vm[x > 1.7].max()
    assert np.all(np.isfinite(vm)) and vm.max() > 0
