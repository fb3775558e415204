"""What runs where: the XLA stencil apply against float64, the double-f32
pair arithmetic, the one backend policy, device post-processing, the
compile-cache location and the bandwidth report's plumbing."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_solver import config
from pde_solver.mesh import box_mesh, interval_mesh, rectangle_mesh
from pde_solver.ops import assembly, df32
from pde_solver.ops.linsolve import _np_shift, _stencil_apply, np_stencil_apply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESHES = {1: lambda: interval_mesh(9, 0.0, 1.0),
          2: lambda: rectangle_mesh(7, 5, (0.0, 0.0), (1.0, 1.0)),
          3: lambda: box_mesh(5, 4, 3, (0, 0, 0), (1.0, 1.0, 1.0))}


def _random_system(dim, vdim, seed=0):
    """Random weights on the P1 offsets of a ``dim``-D mesh, zero where a
    neighbour falls outside the grid (as assembled stencils are)."""
    mesh = MESHES[dim]()
    offsets = tuple(sorted(assembly.assemble_scalar_stencil(
        mesh, "stiffness").keys()))
    rng = np.random.default_rng(seed)
    tail = (vdim, vdim) if vdim > 1 else ()
    ones = np.ones(mesh.node_shape)
    W = [rng.standard_normal(mesh.node_shape + tail)
         * _np_shift(ones, o, dim).reshape(mesh.node_shape
                                           + (1,) * len(tail))
         for o in offsets]
    x = rng.standard_normal(mesh.node_shape + ((vdim,) if vdim > 1 else ()))
    return offsets, W, x


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("vdim", [1, 3])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_xla_stencil_apply_matches_float64(dim, vdim, dtype):
    offsets, W, x = _random_system(dim, vdim)
    w = tuple(jnp.asarray(a, dtype) for a in W)
    xd = jnp.asarray(x, dtype)
    y = jax.jit(lambda w, x: _stencil_apply(offsets, w, x, dim, vdim))(w, xd)
    # float64 of the rounded inputs: the only difference is the arithmetic
    y64 = np_stencil_apply({o: np.asarray(a, np.float64)
                            for o, a in zip(offsets, w)},
                           np.asarray(xd, np.float64), dim, vdim)
    err = np.abs(np.asarray(y, np.float64) - y64).max() / np.abs(y64).max()
    assert err <= 8 * np.finfo(np.dtype(dtype)).eps


def test_split_f64_round_trips_to_2_pow_48():
    x = np.random.default_rng(1).standard_normal(5000) * np.exp(
        np.random.default_rng(2).uniform(-30, 30, 5000))
    hi, lo = jax.jit(df32.split_f64)(jnp.asarray(x))
    assert hi.dtype == lo.dtype == jnp.float32
    assert np.all(np.abs(df32.df_to_f64(hi, lo) - x) <= 2.0 ** -48 * np.abs(x))


def test_df_scale_add_matches_float64():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(5000) * 1e3
    d = rng.standard_normal(5000).astype(np.float32)
    hi, lo = df32.df_from_f64(x)
    alpha = np.float32(-0.3)
    got = df32.df_to_f64(*jax.jit(df32.df_scale_add)(hi, lo, alpha, d))
    want = df32.df_to_f64(hi, lo) + np.float64(alpha) * d.astype(np.float64)
    assert np.all(np.abs(got - want) <= 2.0 ** -47 * (np.abs(x) + np.abs(d)))


@pytest.mark.parametrize("vdim", [1, 3])
def test_pair_defect_survives_cancellation(vdim):
    """b = A x (1 + 1e-9): the defect cancels nine digits, and the f32
    result still carries it to f32 rounding."""
    offsets, W, x = _random_system(3, vdim, seed=4)
    b = np_stencil_apply(dict(zip(offsets, W)), x, 3, vdim) * (1 + 1e-9)
    Wp = [df32.df_from_f64(w) for w in W]
    bp, xp = df32.df_from_f64(b), df32.df_from_f64(x)
    r, rn2 = df32.jit_df_residual(
        offsets, tuple(jnp.asarray(p[0]) for p in Wp),
        tuple(jnp.asarray(p[1]) for p in Wp), *map(jnp.asarray, bp),
        *map(jnp.asarray, xp), 3, vdim)
    r64 = df32.df_to_f64(*bp) - np_stencil_apply(
        {o: df32.df_to_f64(*p) for o, p in zip(offsets, Wp)},
        df32.df_to_f64(*xp), 3, vdim)
    assert np.abs(np.asarray(r, np.float64) - r64).max() \
        <= 2.0 ** -22 * np.abs(r64).max()
    assert np.isclose(float(rn2), float(np.sum(np.asarray(r, np.float64) ** 2)),
                      rtol=1e-5)


@pytest.mark.parametrize("platform, want", [
    ("cpu", config.BackendPolicy("f64", "small", False)),
    ("gpu", config.BackendPolicy("mixed", "full", True)),
])
def test_backend_policy(platform, want):
    assert config.backend_policy(platform) == want


@pytest.mark.parametrize("platform, precision", [("cpu", "f64"),
                                                 ("gpu", "mixed")])
def test_auto_precision_follows_policy(monkeypatch, platform, precision):
    monkeypatch.setattr(config.jax, "default_backend", lambda: platform)
    assert config.SolverConfig().resolve_precision() == precision
    assert config.SolverConfig(precision="f32").resolve_precision() == "f32"


def _cantilever_u(mesh, dim):
    rng = np.random.default_rng(5)
    return rng.standard_normal(mesh.node_shape + (dim,)) * 1e-4


@pytest.mark.parametrize("dim", [2, 3])
def test_device_von_mises_matches_host(monkeypatch, dim):
    from pde_solver.models import elasticity

    mesh = MESHES[dim]()
    u = _cantilever_u(mesh, dim)
    lam, mu = elasticity.lame_parameters(210e9, 0.3,
                                         "3d" if dim == 3 else "plane_stress")
    host = elasticity.von_mises_fields(mesh, u, lam, mu)
    monkeypatch.setattr(elasticity, "_VM_DEVICE_MIN_SIZE", 0)
    monkeypatch.setattr(config.jax, "default_backend", lambda: "gpu")
    dev = elasticity.von_mises_fields(mesh, u, lam, mu)
    for h, g in zip(host, dev):
        assert g.dtype == np.float32          # the device path ran
        assert np.abs(g - h).max() <= 1e-5 * np.abs(h).max()


def test_host_von_mises_on_cpu_policy(monkeypatch):
    from pde_solver.models import elasticity

    mesh = MESHES[3]()
    u = _cantilever_u(mesh, 3)
    lam, mu = elasticity.lame_parameters(210e9, 0.3, "3d")
    monkeypatch.setattr(elasticity, "_VM_DEVICE_MIN_SIZE", 0)
    vm, _ = elasticity.von_mises_fields(mesh, u, lam, mu)
    assert vm.dtype == np.float64


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_location(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run(
        [sys.executable, "-c",
         "import pde_solver, jax; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120,
        check=True).stdout.strip().splitlines()[-1]
    want = (os.path.join(REPO, ".jax_cache") if env_dir is None
            else str(tmp_path / env_dir))
    assert out == want


def test_apply_report_plumbing():
    sys.path.insert(0, REPO)
    from benchmarks import spmv_bench

    offsets, W, x = _random_system(3, 3)
    w = tuple(jnp.asarray(a, jnp.float32) for a in W)
    xd = jnp.asarray(x, jnp.float32)
    assert spmv_bench.apply_bytes(w, xd) == (len(W) * W[0].size + 2 * x.size) * 4
    rep = spmv_bench.apply_report(offsets, w, xd, 3, 3, copy_bps=1e9)
    assert rep["apply_ms"] > 0 and rep["bytes"] == spmv_bench.apply_bytes(w, xd)
    assert rep["share_of_copy"] == pytest.approx(rep["bytes_per_s"] / 1e9)
    # a device kind without a published peak reports none
    assert rep["published_peak_bytes_per_s"] is None
    assert rep["share_of_peak"] is None


def test_spmv_bench_refuses_cpu():
    out = subprocess.run([sys.executable, "benchmarks/spmv_bench.py", "4",
                          "2", "2"], capture_output=True, text=True,
                         cwd=REPO, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("vdim", [1, 3])
def test_triton_candidate_interpret_matches_float64(dim, vdim):
    """The Pallas-Triton apply of benchmarks/spmv_bench.py in interpret mode,
    with couplings to off-grid neighbours left nonzero: the flat layout
    must drop them, as the grid apply does."""
    sys.path.insert(0, REPO)
    from benchmarks.spmv_bench import FlatLayout, triton_stencil_apply

    mesh = MESHES[dim]()
    offsets = tuple(sorted(assembly.assemble_scalar_stencil(
        mesh, "stiffness").keys()))
    rng = np.random.default_rng(2)
    tail = (vdim, vdim) if vdim > 1 else ()
    W = [rng.standard_normal(mesh.node_shape + tail) for _ in offsets]
    x = rng.standard_normal(mesh.node_shape + ((vdim,) if vdim > 1 else ()))
    lay = FlatLayout(offsets, mesh.node_shape, block=8)
    y = lay.unpack(jax.jit(triton_stencil_apply(lay, vdim, interpret=True))(
        lay.pack_weights(offsets, W, vdim), lay.pack(x, vdim)), vdim)
    y64 = np_stencil_apply({o: np.asarray(np.float32(a), np.float64)
                            for o, a in zip(offsets, W)},
                           np.asarray(np.float32(x), np.float64), dim, vdim)
    err = np.abs(np.asarray(y, np.float64) - y64).max() / np.abs(y64).max()
    assert err <= 8 * np.finfo(np.float32).eps


@pytest.mark.parametrize("environ, replacement", [
    ({"PDE_X_SHARD_DEVICES": "4"}, "PDE_SHARD_DEVICES"),
    ({"PDE_X_PRECISION": "f64", "PDE_TOL": "1e-9"}, "PDE_PRECISION"),
    ({"PDE_X_CACHE_DIR": "/cache"}, "PDE_CACHE_DIR"),
    ({"PDE_SHARD_DEVICES": "4", "PDE_UNRELATED": "1", "HOME": "/"}, None),
])
def test_check_environment_names_renamed_variables(environ, replacement):
    if replacement is None:
        config.check_environment(environ)
        return
    with pytest.raises(ValueError, match=f"set {replacement} instead"):
        config.check_environment(environ)


def test_env_registry_lists_every_variable_read():
    import glob
    import re

    names = set()
    for pattern in ("*.py", "benchmarks/*.py", "pde_solver/**/*.py"):
        for path in glob.glob(os.path.join(REPO, pattern), recursive=True):
            with open(path, encoding="utf-8") as fh:
                names |= set(re.findall(r"(?<![A-Za-z0-9_])PDE_[A-Z0-9_]+",
                                        fh.read()))
    assert names and names <= config.ENV_VARS, names - config.ENV_VARS
