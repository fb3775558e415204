"""Constant-interior stencil operator (CSOp): bitwise equality with the
dense per-node weight apply, and dense fallback for varying coefficients.

CSOp (constant interior weights + exact thickness-2 boundary slabs) is a
compressed weight representation; it is not wired into the solve paths
(see the ops/linsolve.py CSOp docstring).
"""

import numpy as np
import jax.numpy as jnp

from pde_solver.mesh import box_mesh
from pde_solver.ops import assembly
from pde_solver.ops.bc import DirichletBC, all_boundary
from pde_solver.ops.linsolve import (_stencil_apply, make_cs_op,
                                         prepare_system)


def _scalar_system():
    mesh = box_mesh(10, 8, 6, (0, 0, 0), (1.0, 0.8, 0.6))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    b = assembly.assemble_load(mesh)
    return mesh, prepare_system(K, mesh, bc, b, 1)


def _block_system():
    mesh = box_mesh(12, 6, 6, (0, 0, 0), (1.0, 0.2, 0.2))
    K = assembly.assemble_elasticity_stencil(mesh, 1.21e11, 8.08e10)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=3)
    b = assembly.assemble_vector_load(mesh, np.array([0.0, 0.0, -7.65e4]))
    return mesh, prepare_system(K, mesh, bc, b, 3)


def test_cs_apply_matches_dense_scalar():
    mesh, sysm = _scalar_system()
    cs = make_cs_op(sysm.offsets, sysm.weights, 3, 1, jnp.float64)
    assert cs is not None  # uniform κ → translation-invariant interior
    x = np.random.default_rng(1).standard_normal(mesh.node_shape)
    dense = tuple(jnp.asarray(W) for W in sysm.weights)
    y_d = np.asarray(_stencil_apply(sysm.offsets, dense, jnp.asarray(x), 3, 1))
    y_c = np.asarray(_stencil_apply(sysm.offsets, cs, jnp.asarray(x), 3, 1))
    assert np.array_equal(y_d, y_c)


def test_cs_apply_matches_dense_block():
    # The CS apply expands the 3x3 block product into scalar multiplies, which
    # changes the accumulation order vs the dense batched-einsum path — exact
    # to a few ulps, not bitwise.  (Scalar stencils keep bitwise equality; see
    # test_cs_apply_matches_dense_scalar.)
    mesh, sysm = _block_system()
    for dtype in (jnp.float64, jnp.float32):
        cs = make_cs_op(sysm.offsets, sysm.weights, 3, 3, dtype)
        assert cs is not None
        x = jnp.asarray(
            np.random.default_rng(2).standard_normal(mesh.node_shape + (3,)),
            dtype=dtype)
        dense = tuple(jnp.asarray(W, dtype=dtype) for W in sysm.weights)
        y_d = np.asarray(_stencil_apply(sysm.offsets, dense, x, 3, 3))
        y_c = np.asarray(_stencil_apply(sysm.offsets, cs, x, 3, 3))
        tol = 16 * np.finfo(np.dtype(dtype)).eps
        scale = np.max(np.abs(y_d))
        assert np.allclose(y_d, y_c, rtol=tol, atol=tol * scale), dtype


def test_cs_fallback_for_varying_coefficients():
    mesh = box_mesh(8, 8, 8, (0, 0, 0), (1.0, 1.0, 1.0))
    coeff = np.random.default_rng(3).uniform(
        1.0, 2.0, size=(len(mesh.subelems),) + mesh.n_cells)
    K = assembly.assemble_scalar_stencil(mesh, "stiffness", cell_coeff=coeff)
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    sysm = prepare_system(K, mesh, bc, assembly.assemble_load(mesh), 1)
    assert make_cs_op(sysm.offsets, sysm.weights, 3, 1, jnp.float64) is None


def test_cs_fallback_for_tiny_grids():
    mesh = box_mesh(2, 2, 2, (0, 0, 0), (1.0, 1.0, 1.0))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    sysm = prepare_system(K, mesh, bc, assembly.assemble_load(mesh), 1)
    assert make_cs_op(sysm.offsets, sysm.weights, 3, 1, jnp.float64) is None


def test_ladder_device_cs_expansion_is_bit_identical(monkeypatch):
    """The compact-upload ladder path (CS split shipped, dense pair
    expanded on device) must reproduce the directly-uploaded dense pair
    BITWISE — the solve programs consume the same arrays either way."""
    import jax.numpy as jnp
    from pde_solver.ops import multigrid as mg

    mesh = box_mesh(16, 8, 8, (0, 0, 0), (1.0, 0.5, 0.5))
    K = assembly.assemble_elasticity_stencil(mesh, 1.21e11, 8.08e10)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=3)
    b = assembly.assemble_vector_load(mesh, np.array([0.0, 0.0, -7.65e4]))
    sysm = prepare_system(K, mesh, bc, b, 3)

    def builder(mc):
        return (assembly.assemble_elasticity_stencil(mc, 1.21e11, 8.08e10),
                DirichletBC.from_masks([(mc.face_mask(0, 0), 0.0)],
                                       mc.node_shape, vdim=3))

    h = mg.build_hierarchy(mesh, sysm, builder, vdim=3, dtype=jnp.float32)
    assert h is not None
    lad_dense = mg.build_df_ladder(h, sysm, sysm.b_hat)
    # production shape: only the FINE level crosses the size threshold
    fine_bytes = (2 * 4 * len(h.levels[0].offsets)
                  * int(np.prod(h.levels[0].free.shape[:3])) * 9)
    monkeypatch.setattr(mg, "_CS_LADDER_MIN_BYTES", fine_bytes)
    lad_cs = mg.build_df_ladder(h, sysm, sysm.b_hat)
    for Whi1, Whi2, Wlo1, Wlo2 in zip(lad_dense.Whi, lad_cs.Whi,
                                      lad_dense.Wlo, lad_cs.Wlo):
        for a1, a2 in zip(Whi1 + Wlo1, Whi2 + Wlo2):
            np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
