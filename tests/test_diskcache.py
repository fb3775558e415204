"""Disk-cache layer tests: npz round-trip, prepare_system persistence,
hierarchy rebuild parity, and the scoped-config override."""

import numpy as np
import jax.numpy as jnp
import pytest

from pde_solver.config import config_overrides, get_config
from pde_solver.mesh import box_mesh
from pde_solver.ops import assembly
from pde_solver.ops import linsolve
from pde_solver.ops import multigrid as mg
from pde_solver.ops.bc import DirichletBC, all_boundary
from pde_solver.ops.linsolve import prepare_system
from pde_solver.utils import diskcache


@pytest.fixture()
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PDE_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("PDE_DISK_CACHE", "1")
    return tmp_path


def test_roundtrip_arrays_and_meta(cache_dir):
    key = ("some", "key", 3)
    arrays = {"a": np.arange(12.0).reshape(3, 4),
              "b": np.ones(5, dtype=np.float32)}
    diskcache.store("t", key, arrays, meta={"x": 1, "names": ["p", "q"]})
    ent = diskcache.load("t", key)
    assert ent is not None
    np.testing.assert_array_equal(ent["a"], arrays["a"])
    assert ent["b"].dtype == np.float32
    assert ent["meta"] == {"x": 1, "names": ["p", "q"]}
    assert diskcache.load("t", ("other",)) is None


def test_eviction_bounds_total_bytes(cache_dir, monkeypatch):
    monkeypatch.setenv("PDE_CACHE_MAX_GB", str(1.0 / 1024))  # 1 MiB
    import time
    for i in range(6):
        diskcache.store("e", i, {"a": np.zeros(400_00, dtype=np.float64)})
        time.sleep(0.01)  # distinct mtimes for LRU ordering
    present = [i for i in range(6) if diskcache.load("e", i) is not None]
    assert present, "eviction removed everything"
    assert 0 not in present, "oldest entry should be evicted first"


def _small_system(cells=(6, 4, 4)):
    mesh = box_mesh(*cells, (0, 0, 0), (1.0, 1.0, 1.0))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    b = assembly.assemble_load(mesh)
    return mesh, K, bc, b


def test_prepare_system_disk_persistence(cache_dir, monkeypatch):
    monkeypatch.setattr(linsolve, "_PREP_CACHE_MIN_DOF", 1)
    mesh, K, bc, b = _small_system()
    s1 = prepare_system(K, mesh, bc, b, 1)
    assert s1.ckey is not None
    # fresh-process simulation: clear the in-memory cache, keep the disk
    linsolve._PREP_CACHE.clear()
    s2 = prepare_system(K, mesh, bc, b, 1)
    for W1, W2 in zip(s1.weights, s2.weights):
        np.testing.assert_array_equal(np.asarray(W1), np.asarray(W2))
    np.testing.assert_allclose(s1.b_hat, s2.b_hat, rtol=0, atol=0)
    # cached arrays are read-only (shared across ScaledSystems)
    with pytest.raises(ValueError):
        np.asarray(s2.weights[0])[0] = 99.0


def _hier_fixture(dtype):
    mesh, K, bc, b = _small_system((8, 8, 8))
    sysm = prepare_system(K, mesh, bc, b, 1)

    def builder(mc):
        return (assembly.assemble_scalar_stencil(mc, "stiffness"),
                DirichletBC.from_masks([(all_boundary(mc), 0.0)],
                                       mc.node_shape))

    return mesh, sysm, builder


def test_hierarchy_disk_rebuild_matches_fresh(cache_dir):
    mesh, sysm, builder = _hier_fixture(jnp.float32)
    key = ("test-hier-key",)
    h1 = mg.build_hierarchy_cached(mesh, sysm, builder, vdim=1,
                                   dtype=jnp.float32, cache_key=key)
    assert h1 is not None
    h2 = mg.build_hierarchy_cached(mesh, sysm, builder, vdim=1,
                                   dtype=jnp.float32, cache_key=key)
    assert len(h1.levels) == len(h2.levels)
    for l1, l2 in zip(h1.levels, h2.levels):
        assert l1.offsets == l2.offsets
        assert l1.omega == l2.omega  # cached, not re-estimated
        for w1, w2 in zip(l1.weights, l2.weights):
            np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
        np.testing.assert_array_equal(np.asarray(l1.free), np.asarray(l2.free))
        if l2.host_weights is not None:  # CS-stored levels rebuild device-only
            # host f64 weights round-trip the (hi, lo) pair: 2^-48 grade
            for hw1, hw2 in zip(l1.host_weights, l2.host_weights):
                np.testing.assert_allclose(hw1, hw2, rtol=0, atol=1e-12)
        # the (hi, lo) pairs themselves are bit-exact either way
        for p1, p2 in zip(l1.host_pairs or [], l2.host_pairs or []):
            for a1, a2 in zip(p1, p2):
                np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
    np.testing.assert_array_equal(np.asarray(h1.levels[-1].Ainv),
                                  np.asarray(h2.levels[-1].Ainv))
    # the df ladder from the rebuilt hierarchy is bit-identical
    lad1 = mg.build_df_ladder(h1, sysm, sysm.b_hat)
    lad2 = mg.build_df_ladder(h2, sysm, sysm.b_hat)
    for Whi1, Whi2 in zip(lad1.Whi, lad2.Whi):
        for a1, a2 in zip(Whi1, Whi2):
            np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
    # and both hierarchies solve to the same answer
    x1, k1, r1 = mg.solve_mg(h1, sysm.b_hat.astype(np.float32), None, 1e-6, 100)
    x2, k2, r2 = mg.solve_mg(h2, sysm.b_hat.astype(np.float32), None, 1e-6, 100)
    assert int(k1) == int(k2)
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))


def test_hierarchy_cache_ignored_for_f64(cache_dir):
    mesh, sysm, builder = _hier_fixture(jnp.float64)
    key = ("f64-key",)
    mg.build_hierarchy_cached(mesh, sysm, builder, vdim=1,
                              dtype=jnp.float64, cache_key=key)
    # nothing stored: the f64 path must not round-trip through f32 pairs
    assert diskcache.load("mgh", (key, 1)) is None


def test_config_overrides_scoped():
    base_theta = get_config().theta
    with config_overrides(theta=0.5):
        assert get_config().theta == 0.5
        with config_overrides(maxiter=7):
            assert get_config().theta == 0.5
            assert get_config().maxiter == 7
        assert get_config().maxiter is None
    assert get_config().theta == base_theta


def test_hierarchy_cs_disk_rebuild_block(cache_dir):
    """Uniform elasticity levels store as constant-interior splits and
    rebuild via device-side expansion — bit-identical device weights, no
    host weight materialization."""
    from pde_solver.models.elasticity import lame_parameters

    mesh = box_mesh(16, 6, 6, (0, 0, 0), (1.0, 0.2, 0.2))
    lam, mu = lame_parameters(210e9, 0.3, "3d")
    K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
    bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                mesh.node_shape, vdim=3)
    b = assembly.assemble_vector_load(mesh, np.array([0.0, 0.0, -7.65e4]))
    sysm = prepare_system(K, mesh, bc, b, 3)

    def builder(mc):
        return (assembly.assemble_elasticity_stencil(mc, lam, mu),
                DirichletBC.from_masks([(mc.face_mask(0, 0), 0.0)],
                                       mc.node_shape, vdim=3))

    key = ("cs-block-key",)
    h1 = mg.build_hierarchy_cached(mesh, sysm, builder, vdim=3,
                                   dtype=jnp.float32, cache_key=key)
    ent = diskcache.load("mgh", (key, 3))
    assert ent is not None and ent["meta"]["cs"][0] is True  # CS stored
    h2 = mg.load_hierarchy_from_disk(key, 3, jnp.float32)
    assert h2 is not None
    for l1, l2 in zip(h1.levels, h2.levels):
        assert l1.omega == l2.omega
        w1 = (l1.weights.Wf,) if hasattr(l1.weights, "Wf") else l1.weights
        w2 = (l2.weights.Wf,) if hasattr(l2.weights, "Wf") else l2.weights
        for a1, a2 in zip(w1, w2):
            np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
        np.testing.assert_array_equal(np.asarray(l1.C), np.asarray(l2.C))
    # ladder from the CS-rebuilt hierarchy is bit-identical too
    lad1 = mg.build_df_ladder(h1, sysm, sysm.b_hat)
    lad2 = mg.build_df_ladder(h2, sysm, sysm.b_hat)
    for W1, W2 in zip(lad1.Whi + lad1.Wlo, lad2.Whi + lad2.Wlo):
        for a1, a2 in zip(W1, W2):
            np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
    # and it solves
    x2, k2, r2 = mg.solve_mg(h2, sysm.b_hat.astype(np.float32), None,
                             1e-6, 200)
    x1, k1, r1 = mg.solve_mg(h1, sysm.b_hat.astype(np.float32), None,
                             1e-6, 200)
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))
