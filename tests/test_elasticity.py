"""Elasticity output-quantity extensions (displacement field).

The reference clamps quantity to stress|strain (dispatcher_agent.py:1002-1005);
these cover the displacement extension against exact/beam-theory values."""

def test_displacement_quantity_1d_exact():
    """quantity='displacement' (extension): u(x) = P x/(EA) exactly for
    the end-loaded fixed-free bar."""
    from pde_solver import api
    from pde_solver.fields import load_field
    res = api.solve_elasticity_1D_loaded(L=1.0, nx=50, E=210e9, area=1e-4,
                                         end_load=10e3,
                                         quantity="displacement")
    f = load_field(res.data_file)
    u = f.values_array()[-1]
    exact = 10e3 * 1.0 / (210e9 * 1e-4)
    assert abs(u[-1] - exact) / exact < 1e-10
    assert f.meta["name"] == "axial_displacement"
    assert f.meta["unit"] == "m"


def test_displacement_quantity_2d_udl_beam_theory():
    """A slender cantilever under a uniform body load: the FEM tip
    deflection must sit within ~15% of the Euler-Bernoulli value
    w L^4/(8 E I) (shear deformation + P1 stiffness account for the
    gap at slenderness 10)."""
    from pde_solver import api
    from pde_solver.fields import load_field
    w = 2000.0           # N/m line load
    Lx, Ly = 3.0, 0.3
    res = api.solve_elasticity_2D_static(Lx=Lx, Ly=Ly, nx=60, ny=8,
                                         E=210e9, nu=0.3,
                                         body_fy=-w / Ly,
                                         quantity="displacement")
    f = load_field(res.data_file)
    tip = float(f.values_array()[-1].max())
    eb = w * Lx**4 / (8 * 210e9 * (Ly**3 / 12.0))
    assert abs(tip - eb) / eb < 0.15
    assert f.meta["name"] == "displacement_magnitude"
    assert f.meta["unit"] == "m"
