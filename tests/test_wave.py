"""Scalar wave-equation family (extension — the reference parses
pde_type='wave' but has no solver for it; models/wave.py).

Correctness anchors: analytic standing waves u = A·sin(kx)·cos(ckt) on
fixed-end domains, discrete energy conservation of the Newmark β=¼/γ=½
integrator, and end-to-end NL routing through the dispatcher.
"""

import os

import numpy as np
import pytest

from pde_solver import api
from pde_solver.config import SolverConfig
from pde_solver.fields import load_field
from pde_solver.mesh import interval_mesh, rectangle_mesh
from pde_solver.models.wave import WaveProblem, solve_wave_problem
from pde_solver.ops import assembly

CFG64 = SolverConfig(precision="f64", tol=1e-12)


def test_wave_1d_standing_mode_analytic():
    """u0 = sin(πx/L), fixed ends: u(x,t) = sin(πx/L)·cos(ωt), ω = cπ/L.
    P1-consistent-mass spatial error is O(h²), Newmark period error O(dt²)."""
    L, c = 2.0, 3.0
    mesh = interval_mesh(96, 0.0, L)
    omega = c * np.pi / L
    period = 2 * np.pi / omega
    n = 200
    p = WaveProblem(mesh=mesh, wave_speed=c, initial_type="sine",
                    initial_amplitude=1.0, initial_wavenumber=np.pi / L,
                    dt=period / n, num_steps=n)
    times, values, info = solve_wave_problem(p, config=CFG64)
    assert info["converged"]
    x = mesh.axis_nodes(0)
    exact = np.sin(np.pi * x / L)[None, :] * np.cos(omega * times)[:, None]
    err = np.linalg.norm(values - exact) / np.linalg.norm(exact)
    assert err < 2e-2, err
    # after one full period the field returns to the IC
    assert np.linalg.norm(values[-1] - values[0]) \
        / np.linalg.norm(values[0]) < 3e-2
    # and the half-period frame is the negated IC
    assert np.linalg.norm(values[n // 2] + values[0]) \
        / np.linalg.norm(values[0]) < 3e-2


def test_wave_1d_newmark_dt_convergence_order2():
    """Halving dt must cut the trajectory error ~4× (Newmark is O(dt²)).
    Spatial error cancels (same mesh everywhere); the anchor is a dt/8 run
    sampled at the coarse frames.  NOTE: the error must be measured over
    the whole trajectory — the end-of-period frame sits at a stationary
    phase point (d cos/dφ = 0 at 2π) where the leading dt² phase error
    vanishes and the comparison degenerates to noisy O(dt⁴)."""
    L, c = 1.0, 1.0
    mesh = interval_mesh(48, 0.0, L)
    period = 2 * L / c
    runs = {}
    for n in (800, 100, 50):
        p = WaveProblem(mesh=mesh, wave_speed=c, initial_type="sine",
                        initial_wavenumber=np.pi / L,
                        dt=period / n, num_steps=n)
        _, values, _ = solve_wave_problem(p, config=CFG64)
        runs[n] = values
    # relative per run: the two comparisons span different frame counts
    # (201 vs 101), so each must normalize by its own reference norm
    errs = {n: np.linalg.norm(runs[n] - runs[800][::800 // n])
            / np.linalg.norm(runs[800][::800 // n])
            for n in (100, 50)}
    ratio = errs[50] / errs[100]
    assert 3.3 < ratio < 4.8, (errs, ratio)


def test_wave_2d_membrane_mode_frequency():
    """Unit membrane fundamental: u0 = sin(πx)sin(πy), ω = cπ√2."""
    c = 2.0
    mesh = rectangle_mesh(40, 40, (0.0, 0.0), (1.0, 1.0))
    omega = c * np.pi * np.sqrt(2.0)
    period = 2 * np.pi / omega
    n = 120
    p = WaveProblem(mesh=mesh, wave_speed=c, initial_type="sine",
                    initial_wavenumber=np.pi, dt=period / n, num_steps=n)
    times, values, info = solve_wave_problem(p, config=CFG64)
    assert info["converged"]
    mid = values[:, values.shape[1] // 2]
    # center value: A·cos(ωt) — check the half/full-period signature
    assert abs(values[n // 2].min() + values[0].max()) \
        / values[0].max() < 5e-2
    assert np.linalg.norm(values[-1] - values[0]) \
        / np.linalg.norm(values[0]) < 6e-2
    # no energy blow-up (the P1 discrete mode differs from the continuous
    # sine by O(h²) projection ripple, so allow ~2e-3 over the IC peak)
    assert mid.max() <= 1.0 + 5e-3


def test_wave_energy_conservation():
    """β=¼, γ=½, f=0: E = ½vᵀMv + ½uᵀ(c²K)u is conserved to solver tol."""
    c = 2.0
    mesh = interval_mesh(32, 0.0, 1.0)
    p = WaveProblem(mesh=mesh, wave_speed=c, initial_type="sine",
                    initial_wavenumber=np.pi, dt=0.004, num_steps=150)
    from pde_solver.ops.timestepping import run_newmark
    from pde_solver.ops.bc import DirichletBC

    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    K = {o: c * c * W for o, W in K.items()}
    M = assembly.assemble_scalar_stencil(mesh, "mass")
    bc = DirichletBC.from_masks([(mesh.boundary_mask(), 0.0)],
                                mesh.node_shape)
    x = mesh.axis_nodes(0)
    u0 = np.sin(np.pi * x)
    res = run_newmark(K, M, mesh, bc, np.zeros_like(u0), u0,
                      np.zeros_like(u0), p.dt, p.num_steps, config=CFG64)
    Kd = assembly.stencil_to_dense(mesh, K)
    Md = assembly.stencil_to_dense(mesh, M)
    E = [0.5 * v.reshape(-1) @ Md @ v.reshape(-1)
         + 0.5 * u.reshape(-1) @ Kd @ u.reshape(-1)
         for u, v in zip(res.values, res.velocities)]
    E = np.asarray(E)
    assert np.abs(E - E[0]).max() / E[0] < 1e-8


def test_wave_constant_source_steady_limit():
    """With heavy implicit damping absent, the time-average of u under a
    constant source oscillates about the static solution −c²Δu = f; check
    the mean over whole periods approximates the steady profile."""
    c, L, f = 1.0, 1.0, 5.0
    mesh = interval_mesh(64, 0.0, L)
    period = 2 * L / c
    n_per = 100
    p = WaveProblem(mesh=mesh, wave_speed=c, initial_type="zero",
                    source_value=f, dt=period / n_per, num_steps=4 * n_per)
    _, values, _ = solve_wave_problem(p, config=CFG64)
    x = mesh.axis_nodes(0)
    static = f * x * (L - x) / (2 * c * c)    # −c²u'' = f, u(0)=u(L)=0
    mean = values[1:].mean(axis=0)            # average over 4 full periods
    err = np.linalg.norm(mean - static) / np.linalg.norm(static)
    assert err < 0.08, err


def test_wave_api_tools(tmp_path):
    """solve_wave_{1,2,3}D artifacts: shapes, meta keys, default IC mode."""
    res1 = api.solve_wave_1D(length=1.0, nx=24, wave_speed=2.0,
                             dt=0.005, num_steps=8,
                             data_dir=str(tmp_path))
    f1 = load_field(res1.data_file)
    assert f1.values.shape == (9, 25)
    assert f1.coords.shape == (25, 3)
    assert f1.meta["pde"] == "wave_1d" and f1.meta["wave_speed"] == 2.0
    assert f1.meta["name"] == "displacement"
    assert f1.meta["integrator"] == "newmark_beta"
    # default wavenumber = fundamental π/L → u0 vanishes at the ends
    assert abs(f1.values[0, 0]) < 1e-12 and abs(f1.values[0, -1]) < 1e-12
    assert abs(f1.values[0].max() - 1.0) < 5e-3   # sine peak ≈ amplitude

    res2 = api.solve_wave_2D(nx=8, ny=8, dt=0.01, num_steps=3,
                             data_dir=str(tmp_path))
    f2 = load_field(res2.data_file)
    assert f2.values.shape == (4, 81) and f2.dim == 2

    res3 = api.solve_wave_3D(nx=5, ny=5, nz=5, dt=0.01, num_steps=2,
                             data_dir=str(tmp_path))
    f3 = load_field(res3.data_file)
    assert f3.values.shape == (3, 216) and f3.dim == 3
    assert "solver_stats" in f3.meta


def test_wave_nl_query_end_to_end(tmp_path, monkeypatch):
    """NL wave query → parser → dispatcher → wave solver → HTML plot."""
    monkeypatch.chdir(tmp_path)
    import asyncio
    from pde_solver.agents.orchestrator import MultiAgentOrchestrator
    o = MultiAgentOrchestrator()
    res = asyncio.new_event_loop().run_until_complete(o.solve(
        "simulate a wave on a 2 m string with wave speed 4, nx 20, "
        "for 10 steps"))
    assert res.get("data_file"), res
    f = load_field(res["data_file"])
    assert f.meta["pde"] == "wave_1d" and f.meta["wave_speed"] == 4.0
    assert os.path.exists(res["html_path"])
    assert "Wave speed: 4" in res["summary"]
    assert "transient (Newmark)" in res["summary"]


def test_sharded_wave_matches_single_device():
    """shard_devices>1 routes the wave model through the shard_mapped
    Newmark scan (scalar vdim=1 leg of the same machinery the sharded
    elastodynamics test witnesses)."""
    from pde_solver.config import config_overrides

    mesh = rectangle_mesh(13, 9, (0.0, 0.0), (1.0, 1.0))
    p = WaveProblem(mesh=mesh, wave_speed=2.0, initial_type="sine",
                    initial_wavenumber=np.pi, dt=0.004, num_steps=8)
    times, ref, _ = solve_wave_problem(p)
    with config_overrides(shard_devices=8):
        _, sh, _ = solve_wave_problem(p)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(sh - ref).max() < 1e-6 * scale
