"""Native C++ runtime tests (skipped when no compiler is available)."""

import numpy as np
import pytest

from pde_solver import native
from pde_solver.mesh import box_mesh
from pde_solver.ops import assembly
from pde_solver.ops.bc import DirichletBC
from pde_solver.ops.linsolve import np_stencil_apply, prepare_system

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")


def _system(vdim):
    mesh = box_mesh(6, 5, 4, (0, 0, 0), (1.0, 0.8, 0.6))
    if vdim == 1:
        K = assembly.assemble_scalar_stencil(mesh, "stiffness")
        bc = DirichletBC.from_masks([(mesh.boundary_mask(), 1.5)], mesh.node_shape)
        rhs = assembly.assemble_load(mesh)
    else:
        K = assembly.assemble_elasticity_stencil(mesh, 1.3, 0.7)
        bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                    mesh.node_shape, vdim=3)
        rhs = assembly.assemble_vector_load(mesh, np.array([0.0, 1.0, -2.0]))
    sysm = prepare_system(K, mesh, bc, rhs, vdim)
    return mesh, sysm


@pytest.mark.parametrize("vdim", [1, 3])
def test_native_stencil_apply_matches_numpy(vdim):
    mesh, sysm = _system(vdim)
    W, deltas = native.pack_flat_stencil(sysm.offsets, sysm.weights,
                                         mesh.node_shape, vdim)
    rng = np.random.default_rng(0)
    x_grid = rng.standard_normal(sysm.b_hat.shape)
    y_np = np_stencil_apply(dict(zip(sysm.offsets, sysm.weights)), x_grid,
                            mesh.dim, vdim)
    x_flat = x_grid.reshape(W.shape[1], vdim) if vdim > 1 else x_grid.reshape(-1)
    y_nat = native.stencil_apply(W, deltas, x_flat, vdim)
    assert np.allclose(y_nat.reshape(y_np.shape), y_np, atol=1e-12)


@pytest.mark.parametrize("vdim", [1, 3])
def test_native_residual(vdim):
    mesh, sysm = _system(vdim)
    W, deltas = native.pack_flat_stencil(sysm.offsets, sysm.weights,
                                         mesh.node_shape, vdim)
    rng = np.random.default_rng(1)
    x_grid = rng.standard_normal(sysm.b_hat.shape)
    x_flat = x_grid.reshape(-1, vdim) if vdim > 1 else x_grid.reshape(-1)
    b_flat = (sysm.b_hat.reshape(-1, vdim) if vdim > 1
              else sysm.b_hat.reshape(-1))
    r, rnorm, scale = native.stencil_residual(W, deltas, x_flat, b_flat, vdim)
    r_ref = sysm.b_hat - np_stencil_apply(dict(zip(sysm.offsets, sysm.weights)),
                                          x_grid, mesh.dim, vdim)
    assert np.allclose(r.reshape(r_ref.shape), r_ref, atol=1e-12)
    assert rnorm == pytest.approx(np.linalg.norm(r_ref.reshape(-1)), rel=1e-12)
    assert scale == pytest.approx(np.max(np.abs(r_ref)), rel=1e-12)


def test_tsf_codec_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    coords = rng.standard_normal((50, 3))
    values = rng.standard_normal((7, 50))
    times = np.linspace(0, 1, 7)
    meta = {"name": "temperature", "unit": "°C", "steady": False, "n": 3}
    path = str(tmp_path / "field.tsf")
    native.tsf_write(path, coords, values, times, 2, meta)
    c2, v2, t2, dim2, meta2 = native.tsf_read(path)
    assert np.array_equal(c2, coords)
    assert np.array_equal(v2, values)
    assert np.array_equal(t2, times)
    assert dim2 == 2
    assert meta2["name"] == "temperature"
    assert meta2["n"] == 3
