"""Transient checkpoint/resume (SURVEY §5): interrupted scans resume from
the persisted carry and reproduce the uninterrupted trajectory bitwise."""

import os

import numpy as np
import pytest

from pde_solver.config import config_overrides
from pde_solver.mesh import rectangle_mesh
from pde_solver.ops import assembly, timestepping
from pde_solver.ops.bc import DirichletBC, all_boundary
from pde_solver.ops.timestepping import run_transient


def _problem():
    mesh = rectangle_mesh(12, 10, (0.0, 0.0), (1.0, 1.0))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    b = assembly.assemble_load(mesh)
    u0 = np.asarray(bc.apply_values(20.0 * np.ones(mesh.node_shape)))
    return mesh, K, M, bc, b, u0


def test_checkpointed_run_matches_plain(tmp_path):
    mesh, K, M, bc, b, u0 = _problem()
    ref = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=10)
    with config_overrides(transient_checkpoint_every=4,
                          checkpoint_dir=str(tmp_path)):
        ck = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=10)
    np.testing.assert_array_equal(ck.values, ref.values)
    assert ck.total_cg_iterations == ref.total_cg_iterations
    assert not os.listdir(tmp_path)  # checkpoint removed on completion


def test_interrupted_run_resumes(tmp_path, monkeypatch):
    mesh, K, M, bc, b, u0 = _problem()
    ref = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=12)
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 1)
    with config_overrides(transient_checkpoint_every=4,
                          checkpoint_dir=str(tmp_path)):
        with pytest.raises(RuntimeError, match="checkpoint test abort"):
            run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=12)
    # one chunk of 4 steps persisted
    files = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert len(files) == 1
    with np.load(os.path.join(tmp_path, files[0])) as z:
        assert int(z["step"]) == 4
    # resume and complete
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 0)
    with config_overrides(transient_checkpoint_every=4,
                          checkpoint_dir=str(tmp_path)):
        ck = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=12)
    np.testing.assert_array_equal(ck.values, ref.values)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".npz")]


def test_checkpoint_key_covers_boundary_values(tmp_path, monkeypatch):
    """A checkpoint from T_boundary=5 must not be resumed by a run with
    T_boundary=7 (the content key covers the lift/BC data)."""
    mesh = rectangle_mesh(12, 10, (0.0, 0.0), (1.0, 1.0))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    b = assembly.assemble_load(mesh)
    u0 = np.zeros(mesh.node_shape)
    bc5 = DirichletBC.from_masks([(all_boundary(mesh), 5.0)],
                                 mesh.node_shape)
    bc7 = DirichletBC.from_masks([(all_boundary(mesh), 7.0)],
                                 mesh.node_shape)
    ref7 = run_transient(K, M, mesh, bc7, b, u0, dt=0.01, num_steps=8)
    # interrupt a T=5 run, leaving its checkpoint behind
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 1)
    with config_overrides(transient_checkpoint_every=4,
                          checkpoint_dir=str(tmp_path)):
        with pytest.raises(RuntimeError, match="checkpoint test abort"):
            run_transient(K, M, mesh, bc5, b, u0, dt=0.01, num_steps=8)
    assert [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    # a T=7 run must ignore it and produce the correct trajectory
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 0)
    with config_overrides(transient_checkpoint_every=4,
                          checkpoint_dir=str(tmp_path)):
        ck7 = run_transient(K, M, mesh, bc7, b, u0, dt=0.01, num_steps=8)
    np.testing.assert_array_equal(ck7.values, ref7.values)


def test_resume_with_shorter_target_is_consistent(tmp_path, monkeypatch):
    """A checkpoint ahead of a (shorter) re-request is discarded — the
    result matches the fresh short run with consistent values/times."""
    mesh, K, M, bc, b, u0 = _problem()
    ref2 = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=2)
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 1)
    with config_overrides(transient_checkpoint_every=4,
                          checkpoint_dir=str(tmp_path)):
        with pytest.raises(RuntimeError, match="checkpoint test abort"):
            run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=12)
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 0)
    with config_overrides(transient_checkpoint_every=4,
                          checkpoint_dir=str(tmp_path)):
        ck2 = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=2)
    assert ck2.values.shape[0] == ck2.times.shape[0] == 3
    np.testing.assert_array_equal(ck2.values, ref2.values)
    np.testing.assert_array_equal(ck2.times, ref2.times)


def test_checkpointed_run_applies_snapshot_thinning(tmp_path):
    """The checkpointed path thins snapshots like the plain path — the
    stored trajectory and the on-disk checkpoint stay budget-bounded."""
    mesh, K, M, bc, b, u0 = _problem()
    with config_overrides(snapshot_max_frames=5):
        ref = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=20)
    with config_overrides(transient_checkpoint_every=8,
                          checkpoint_dir=str(tmp_path),
                          snapshot_max_frames=5):
        ck = run_transient(K, M, mesh, bc, b, u0, dt=0.01, num_steps=20)
    assert ck.values.shape[0] == ref.values.shape[0] <= 7
    np.testing.assert_array_equal(ck.values, ref.values)
    np.testing.assert_array_equal(ck.times, ref.times)


# ----------------------------------------------------------------------
# Newmark (elastodynamics / wave) checkpoint/resume
# ----------------------------------------------------------------------

def _newmark_problem():
    mesh = rectangle_mesh(12, 10, (0.0, 0.0), (1.0, 1.0))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    K = {o: 4.0 * W for o, W in K.items()}        # c² = 4
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    x, y = np.meshgrid(mesh.axis_nodes(0), mesh.axis_nodes(1),
                       indexing="ij")
    u0 = np.sin(np.pi * x) * np.sin(np.pi * y)
    v0 = np.zeros_like(u0)
    f = np.zeros_like(u0)
    return mesh, K, M, bc, f, u0, v0


def test_newmark_checkpointed_run_matches_plain(tmp_path):
    from pde_solver.ops.timestepping import run_newmark
    mesh, K, M, bc, f, u0, v0 = _newmark_problem()
    ref = run_newmark(K, M, mesh, bc, f, u0, v0, dt=0.005, num_steps=10)
    with config_overrides(transient_checkpoint_every=4,
                          checkpoint_dir=str(tmp_path)):
        ck = run_newmark(K, M, mesh, bc, f, u0, v0, dt=0.005, num_steps=10)
    np.testing.assert_array_equal(ck.values, ref.values)
    np.testing.assert_array_equal(ck.velocities, ref.velocities)
    assert ck.total_cg_iterations == ref.total_cg_iterations
    assert not os.listdir(tmp_path)  # checkpoint removed on completion


def test_newmark_interrupted_run_resumes_bitwise(tmp_path, monkeypatch):
    from pde_solver.ops.timestepping import run_newmark
    mesh, K, M, bc, f, u0, v0 = _newmark_problem()
    ref = run_newmark(K, M, mesh, bc, f, u0, v0, dt=0.005, num_steps=12)
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 1)
    with config_overrides(transient_checkpoint_every=4,
                          checkpoint_dir=str(tmp_path)):
        with pytest.raises(RuntimeError, match="checkpoint test abort"):
            run_newmark(K, M, mesh, bc, f, u0, v0, dt=0.005, num_steps=12)
    files = [fn for fn in os.listdir(tmp_path) if fn.endswith(".npz")]
    assert len(files) == 1 and files[0].startswith("newmark-")
    with np.load(os.path.join(tmp_path, files[0])) as z:
        assert int(z["step"]) == 4
        assert z["us"].shape[0] == 4          # 4 persisted frames
        assert {"u", "v", "a"} <= set(z.files)  # full carry persisted
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 0)
    with config_overrides(transient_checkpoint_every=4,
                          checkpoint_dir=str(tmp_path)):
        ck = run_newmark(K, M, mesh, bc, f, u0, v0, dt=0.005, num_steps=12)
    # the acceleration is carried explicitly → the resume is BITWISE
    np.testing.assert_array_equal(ck.values, ref.values)
    np.testing.assert_array_equal(ck.velocities, ref.velocities)
    assert not [fn for fn in os.listdir(tmp_path) if fn.endswith(".npz")]


def test_newmark_checkpoint_longer_target_continues(tmp_path, monkeypatch):
    """num_steps is excluded from the content key: a longer request resumes
    a shorter/killed run's chunks instead of recomputing them."""
    from pde_solver.ops.timestepping import run_newmark
    mesh, K, M, bc, f, u0, v0 = _newmark_problem()
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 1)
    with config_overrides(transient_checkpoint_every=4,
                          checkpoint_dir=str(tmp_path)):
        with pytest.raises(RuntimeError):
            run_newmark(K, M, mesh, bc, f, u0, v0, dt=0.005, num_steps=6)
    files = [fn for fn in os.listdir(tmp_path) if fn.endswith(".npz")]
    assert len(files) == 1   # 4 of the 6 steps persisted
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 0)
    ref = run_newmark(K, M, mesh, bc, f, u0, v0, dt=0.005, num_steps=12)
    with config_overrides(transient_checkpoint_every=4,
                          checkpoint_dir=str(tmp_path)):
        ck = run_newmark(K, M, mesh, bc, f, u0, v0, dt=0.005, num_steps=12)
    np.testing.assert_array_equal(ck.values, ref.values)


def test_wave_model_checkpoint_roundtrip(tmp_path):
    """The wave family inherits Newmark checkpointing through run_newmark."""
    from pde_solver.mesh import interval_mesh
    from pde_solver.models.wave import WaveProblem, solve_wave_problem
    mesh = interval_mesh(24, 0.0, 1.0)
    p = WaveProblem(mesh=mesh, wave_speed=2.0, initial_type="sine",
                    initial_wavenumber=np.pi, dt=0.004, num_steps=9)
    _, ref, _ = solve_wave_problem(p)
    with config_overrides(transient_checkpoint_every=4,
                          checkpoint_dir=str(tmp_path)):
        _, ck, _ = solve_wave_problem(p)
    np.testing.assert_array_equal(ck, ref)


def test_cnab2_interrupted_run_resumes_bitwise(tmp_path, monkeypatch):
    """CNAB2's AB2 history (u_prev) persists in the checkpoint: an
    interrupted run resumes with the exact convection extrapolation, so the
    trajectory matches the uninterrupted scan bitwise."""
    mesh = rectangle_mesh(12, 10, (0.0, 0.0), (1.0, 1.0))
    K = {o: 0.05 * W for o, W in assembly.assemble_scalar_stencil(
        mesh, "stiffness").items()}
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    C = assembly.assemble_convection_stencil(mesh, [0.8, -0.3])
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    b = assembly.assemble_load(mesh)
    u0 = np.asarray(bc.apply_values(
        np.exp(-((mesh.node_coords[..., 0] - 0.4) ** 2
                 + (mesh.node_coords[..., 1] - 0.6) ** 2) / 0.04)))
    kw = dict(dt=0.005, num_steps=12, theta=0.5, C_np=C,
              convection_scheme="cnab2")
    ref = run_transient(K, M, mesh, bc, b, u0, **kw)
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 1)
    with config_overrides(transient_checkpoint_every=4,
                          checkpoint_dir=str(tmp_path)):
        with pytest.raises(RuntimeError, match="checkpoint test abort"):
            run_transient(K, M, mesh, bc, b, u0, **kw)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert len(files) == 1
    with np.load(os.path.join(tmp_path, files[0])) as z:
        assert int(z["step"]) == 4
        assert "u_prev" in z.files           # the AB2 history is persisted
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 0)
    with config_overrides(transient_checkpoint_every=4,
                          checkpoint_dir=str(tmp_path)):
        ck = run_transient(K, M, mesh, bc, b, u0, **kw)
    np.testing.assert_array_equal(ck.values, ref.values)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".npz")]


def test_cnab2_checkpoint_key_distinct_from_ab1(tmp_path, monkeypatch):
    """An AB1 run's checkpoint must never seed a CNAB2 run of the same
    problem (different recurrence): the content keys differ."""
    mesh = rectangle_mesh(12, 10, (0.0, 0.0), (1.0, 1.0))
    K = {o: 0.05 * W for o, W in assembly.assemble_scalar_stencil(
        mesh, "stiffness").items()}
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    C = assembly.assemble_convection_stencil(mesh, [0.8, -0.3])
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    b = assembly.assemble_load(mesh)
    u0 = np.asarray(bc.apply_values(np.ones(mesh.node_shape)))
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 1)
    with config_overrides(transient_checkpoint_every=4,
                          checkpoint_dir=str(tmp_path)):
        with pytest.raises(RuntimeError, match="checkpoint test abort"):
            run_transient(K, M, mesh, bc, b, u0, dt=0.005, num_steps=12,
                          theta=0.5, C_np=C, convection_scheme="ab1")
    names_ab1 = set(os.listdir(tmp_path))
    monkeypatch.setattr(timestepping, "_CKPT_TEST_ABORT", 0)
    with config_overrides(transient_checkpoint_every=4,
                          checkpoint_dir=str(tmp_path)):
        ck = run_transient(K, M, mesh, bc, b, u0, dt=0.005, num_steps=12,
                           theta=0.5, C_np=C, convection_scheme="cnab2")
    ref = run_transient(K, M, mesh, bc, b, u0, dt=0.005, num_steps=12,
                        theta=0.5, C_np=C, convection_scheme="cnab2")
    # the stale AB1 artifact was not consumed (still on disk, distinct key)
    assert names_ab1 <= set(os.listdir(tmp_path))
    np.testing.assert_array_equal(ck.values, ref.values)
