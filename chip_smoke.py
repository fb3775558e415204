#!/usr/bin/env python
"""Smoke run of the PDE service on an NVIDIA GPU, end to end.

    python chip_smoke.py               # one card: phases 1-7 below
    python chip_smoke.py --four-cards  # four cards: the sharded path only

One card:

1. card identity (nvidia-smi name and power limit, JAX version, XLA_FLAGS);
2. the served path: ``server.py`` as a child process, driven over MCP stdio
   (initialize, tools/list, three tools/call) plus one natural-language
   query through the orchestrator and the same server.  It runs before this
   process touches the card, since one process holds a card at a time;
3. the 2,040,675-DOF flagship cantilever through
   ``api.solve_elasticity_3D_static``, its true relative residual checked in
   float64 on the host;
4. parity of the same cantilever at the served request's 40×16×16 (so
   the compiled solver is shared with phase 2) against the float64
   per-element surrogate ``tests/reference_fem.py``;
5. transient heat through ``api.solve_heat_3D`` at 128³ (MG-PCG steps),
   64³, and 24³ against reference backward-Euler stepping;
6. precision on the card: the f32 stencil apply against float64, and the
   double-float32 pair arithmetic against float64;
7. the finest-level stencil apply against a device copy measured in the
   same run.

Every check raises on failure, so a failing phase exits non-zero and no
result line is printed.  A passing run ends with one JSON line:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

# The flagship cantilever: 1 m × 0.2 m × 0.2 m steel under gravity.
CANTILEVER = dict(Lx=1.0, Ly=0.2, Lz=0.2, E=210e9, nu=0.3,
                  body_fz=-9.81 * 7800.0)
FLAGSHIP_CELLS = (160, 64, 64)
SERVED_CELLS = (40, 16, 16)
README_QUERY = ("Solve 1D heat transfer in a 2 m rod, left end at 20°C, "
                "right end at 0°C")
N_TOOLS = 31
PARITY_TOL = 1e-6     # the accuracy contract (config.accuracy_target)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


# ----------------------------------------------------------------------
# Phase 1 — card identity
# ----------------------------------------------------------------------

def card_identity() -> str:
    """nvidia-smi's name and power limit; raises where there is no GPU."""
    import jax

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    check(bool(out), "nvidia-smi lists a GPU")
    log(out)
    log(f"[card] jax {jax.__version__}  "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}")
    return out


def require_gpu(count: int):
    """The devices JAX found; raises unless they are ``count`` GPUs."""
    import jax

    devs = jax.devices()
    log(f"[card] jax.devices() = {devs}")
    check(devs[0].platform == "gpu",
          f"JAX runs on a GPU (found {devs[0].platform})")
    check(len(devs) >= count, f"{count} GPU(s) visible (found {len(devs)})")
    return devs


# ----------------------------------------------------------------------
# Phase 2 — the served path (MCP stdio server in a child process)
# ----------------------------------------------------------------------

def _linear_deviation(data_file: str, T_left: float, T_right: float) -> float:
    """Max |T − linear profile| of the last frame, as a share of the span."""
    from pde_solver.fields import load_field

    f = load_field(data_file)
    x = f.coords[:, 0]
    L = x.max() - x.min()
    lin = T_left + (T_right - T_left) * (x - x.min()) / L
    return float(np.abs(f.values[-1] - lin).max() / abs(T_left - T_right))


async def _served(elastic_cells) -> dict:
    from pde_solver.agents.dispatcher_agent import MCPToolSet
    from pde_solver.agents.orchestrator import MultiAgentOrchestrator

    toolset = MCPToolSet([sys.executable, os.path.join(REPO, "server.py")])
    client = toolset.client
    secs = {}

    async def timed(label, coro):
        t0 = time.perf_counter()
        out = await coro
        secs[label] = time.perf_counter() - t0
        log(f"[served] {label}: {secs[label]:.3f} s")
        return out

    try:
        tools = await timed("initialize + tools/list", client.list_tools())
        check(len(tools) == N_TOOLS, f"{N_TOOLS} tools listed "
                                     f"(got {len(tools)})")
        heat = await timed("tools/call solve_heat_1D",
                           client.call_tool("solve_heat_1D", {}))
        nx, ny, nz = elastic_cells
        elast = await timed(
            f"tools/call solve_elasticity_3D_static {nx}x{ny}x{nz}",
            client.call_tool("solve_elasticity_3D_static", dict(
                Lx=CANTILEVER["Lx"], Ly=CANTILEVER["Ly"],
                Lz=CANTILEVER["Lz"], nx=nx, ny=ny, nz=nz,
                body_fz=CANTILEVER["body_fz"])))
        stats = elast["meta"]["solver_stats"]
        check(bool(stats["converged"]), f"elasticity converged ({stats})")
        plot = await timed(
            "tools/call plot_time_series_field_from_file",
            client.call_tool("plot_time_series_field_from_file",
                             {"data_file": elast["data_file"]}))
        html = plot.get("html_path") if isinstance(plot, dict) else None
        orch = MultiAgentOrchestrator(memory_file=None, toolset=toolset,
                                      llm=None)
        nl = await timed("natural-language query", orch.solve(README_QUERY))
    finally:
        await client.close()
    for path in (heat["data_file"], elast["data_file"], nl["data_file"]):
        check(os.path.exists(path), f"data file {path} exists")
    for path in (html, nl["html_path"]):
        check(path is not None and os.path.exists(path),
              f"plot {path} exists")
        with open(path) as fh:
            check("Plotly.newPlot" in fh.read(), f"{path} embeds a plot")
    # t_end = 2 s = L²/(2κ): the slowest mode has decayed to e^{-π²/2}
    # ≈ 0.7 % of its start, so the profile is linear to within 1 % of span
    dev = _linear_deviation(nl["data_file"], 20.0, 0.0)
    log(f"[served] NL query: {nl['data_file']}, deviation from the linear "
        f"profile {dev:.2e} of the span")
    check(dev <= 0.01, "1D rod profile is linear")
    return {"seconds": secs, "elasticity_dof": stats["num_dofs"]}


def served_path(elastic_cells=SERVED_CELLS) -> dict:
    """Start the MCP server as a child of this (not yet initialized)
    process, answer the requests, and stop it."""
    return asyncio.run(_served(elastic_cells))


# ----------------------------------------------------------------------
# Phases 3-4 — the flagship and reduced-size parity, through the API
# ----------------------------------------------------------------------

@contextlib.contextmanager
def capture_solves():
    """Record (stencil, mesh, bc, rhs, solution) of every elasticity linear
    solve made through ``models.elasticity`` inside the block."""
    from pde_solver.models import elasticity

    seen = []
    inner = elasticity.solve_stencil_system

    def recording(K, mesh, bc, b, **kw):
        x, stats = inner(K, mesh, bc, b, **kw)
        seen.append((K, mesh, bc, b, x))
        return x, stats

    elasticity.solve_stencil_system = recording
    try:
        yield seen
    finally:
        elasticity.solve_stencil_system = inner


def true_relres(K, mesh, bc, b, x) -> float:
    """‖b̂ − Â x̂‖/‖b̂‖ of the scaled system in float64 on the host."""
    from pde_solver.ops.linsolve import np_stencil_apply, prepare_system

    vdim = x.shape[-1] if x.ndim > mesh.dim else 1
    sysm = prepare_system(K, mesh, bc, b, vdim)
    x_hat = sysm.to_hat_x(np.asarray(x, np.float64))
    r = sysm.b_hat - np_stencil_apply(dict(zip(sysm.offsets, sysm.weights)),
                                      x_hat, mesh.dim, vdim)
    return float(np.linalg.norm(r) / np.linalg.norm(sysm.b_hat))


def cantilever(cells):
    """One solve of the cantilever through the public API; returns
    (solver_stats, wall seconds, captured solve)."""
    from pde_solver import api

    nx, ny, nz = cells
    with capture_solves() as seen:
        t0 = time.perf_counter()
        res = api.solve_elasticity_3D_static(
            Lx=CANTILEVER["Lx"], Ly=CANTILEVER["Ly"], Lz=CANTILEVER["Lz"],
            nx=nx, ny=ny, nz=nz, E=CANTILEVER["E"], nu=CANTILEVER["nu"],
            body_fz=CANTILEVER["body_fz"])
        wall = time.perf_counter() - t0
    check(len(seen) == 1, "one linear solve per call")
    return res.meta["solver_stats"], wall, seen[0]


def peak_memory_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def flagship(cells=FLAGSHIP_CELLS):
    """The flagship twice (cold, then warm) with per-phase seconds; returns
    its prepared (scaled) system."""
    from pde_solver.ops.linsolve import prepare_system

    s1, wall1, solve = cantilever(cells)
    s2, wall2, _ = cantilever(cells)
    relres = true_relres(*solve)
    dof = solve[4].size
    for label, key in (("assembly", "assembly_seconds"),
                       ("prepare", "prepare_seconds"),
                       ("hierarchy build+upload", "hierarchy_seconds"),
                       ("ladder", "ladder_seconds"),
                       ("first solve (with compile)", "iterate_seconds"),
                       ("postprocess", "postprocess_seconds")):
        log(f"[flagship] {label}: {s1.get(key, 0.0):.3f} s")
    log(f"[flagship] second solve: {s2.get('iterate_seconds', 0.0):.3f} s "
        f"(second call wall {wall2:.3f} s; first call wall {wall1:.3f} s)")
    log(f"[flagship] {dof} DOF, iterations {s1['cg_iterations']}, "
        f"solver relres {s1['relative_residual']:.3e}, "
        f"true f64 relres {relres:.3e}, "
        f"peak device memory {peak_memory_bytes()} B")
    check(np.isfinite(relres) and relres <= 1e-6, "flagship relres ≤ 1e-6")
    K, mesh, bc, b, _ = solve
    return prepare_system(K, mesh, bc, b, 3)


def reference_cantilever(cells) -> np.ndarray:
    """The cantilever solved with the float64 per-element surrogate
    (tests/reference_fem.py + scipy), as a [*node_shape, 3] grid."""
    import scipy.sparse.linalg as spla

    import reference_fem as ref

    E, nu = CANTILEVER["E"], CANTILEVER["nu"]
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    extent = (CANTILEVER["Lx"], CANTILEVER["Ly"], CANTILEVER["Lz"])
    verts, cells_ = ref.build_simplices(cells, (0.0, 0.0, 0.0), extent)
    K = ref.assemble_elasticity(verts, cells_, lam, mu)
    b = np.zeros((len(verts), 3))
    b[:, 2] = CANTILEVER["body_fz"] * ref.assemble_load(verts, cells_)
    clamped = np.isclose(verts[:, 0], 0.0)
    free = np.repeat(~clamped, 3)
    u = np.zeros(3 * len(verts))
    Kf = K[free][:, free].tocsc()
    u[free] = spla.spsolve(Kf, b.reshape(-1)[free])
    # reference nodes are x-fastest; the grid is [x, y, z] in C order
    shape = tuple(c + 1 for c in cells)
    return u.reshape(shape[::-1] + (3,)).transpose(2, 1, 0, 3)


def parity(cells=SERVED_CELLS) -> float:
    stats, _, (_, _, _, _, x) = cantilever(cells)
    u_ref = reference_cantilever(cells)
    err = float(np.linalg.norm(x - u_ref) / np.linalg.norm(u_ref))
    log(f"[parity] cantilever {cells}: {x.size} DOF, iterations "
        f"{stats['cg_iterations']}, relative L2 vs reference_fem {err:.3e}")
    check(err <= PARITY_TOL, f"parity ≤ {PARITY_TOL}")
    return err


# ----------------------------------------------------------------------
# Phase 5 — transient heat
# ----------------------------------------------------------------------

def heat_box(n, num_steps, dt=0.01):
    from pde_solver import api
    from pde_solver.fields import load_field

    t0 = time.perf_counter()
    res = api.solve_heat_3D(nx=n, ny=n, nz=n, dt=dt, num_steps=num_steps)
    wall = time.perf_counter() - t0
    st = res.meta["solver_stats"]
    f = load_field(res.data_file)
    check(bool(np.isfinite(f.values).all()), f"heat {n}³ finite")
    scan = st.get("scan_seconds") or st["solve_seconds"]
    log(f"[transient] {n}³ cells, {st['num_dofs']} DOF, {num_steps} steps: "
        f"{num_steps / scan:.1f} steps/s (scan {scan:.3f} s, fetch "
        f"{st.get('fetch_seconds', 0.0):.3f} s, setup "
        f"{st.get('setup_seconds', 0.0):.3f} s, call {wall:.3f} s), "
        f"CG iterations {st['cg_iterations']}")
    return f, st


def reference_heat(n, num_steps, dt=0.01) -> np.ndarray:
    """Backward-Euler stepping of the unit-cube heat problem (κ = 1, u = 0
    on the boundary, u0 = 20) with the float64 surrogate; [Nt+1, N] in the
    surrogate's node order."""
    import scipy.sparse.linalg as spla

    import reference_fem as ref

    verts, cells_ = ref.build_simplices((n, n, n), (0.0, 0.0, 0.0),
                                        (1.0, 1.0, 1.0))
    K = ref.assemble(verts, cells_, "stiffness")
    M = ref.assemble(verts, cells_, "mass")
    bnd = np.any(np.isclose(verts, 0.0) | np.isclose(verts, 1.0), axis=1)
    free = ~bnd
    u = np.where(free, 20.0, 0.0)
    lu = spla.splu((M + dt * K)[free][:, free].tocsc())
    Mf = M[free][:, free]
    out = [u.copy()]
    for _ in range(num_steps):
        u[free] = lu.solve(Mf @ u[free])
        out.append(u.copy())
    return np.stack(out), verts


def heat_parity(n=24, num_steps=20) -> float:
    """``n``³ heat against reference stepping, with the multigrid thresholds
    lowered to its size so that its steps take the MG-PCG corrections the
    large transients take."""
    from pde_solver.config import config_overrides

    dof = (n + 1) ** 3
    with config_overrides(mg_threshold=dof, transient_mg_threshold=dof):
        f, _ = heat_box(n, num_steps)
    ref_vals, verts = reference_heat(n, num_steps)
    # align node orders through the coordinates
    order_f = np.lexsort(np.round(f.coords, 9).T)
    order_r = np.lexsort(np.round(verts, 9).T)
    err = float(np.linalg.norm(f.values[:, order_f] - ref_vals[:, order_r])
                / np.linalg.norm(ref_vals))
    log(f"[transient] {n}³ vs reference_fem stepping: relative L2 {err:.3e}")
    check(err <= PARITY_TOL, f"transient parity ≤ {PARITY_TOL}")
    return err


def transient(sizes=(128, 64), parity_n=24) -> None:
    for n in sizes:
        heat_box(n, 50)
    heat_parity(parity_n)


# ----------------------------------------------------------------------
# Phase 6 — precision on this card
# ----------------------------------------------------------------------

def stencil_precision(sysm) -> float:
    """The f32 fine-level apply of a prepared system (the flagship's) against
    float64 numpy on the same (f32-rounded) inputs; max error over max |y|."""
    import jax
    import jax.numpy as jnp

    from pde_solver.ops.linsolve import _stencil_apply, np_stencil_apply

    w32 = tuple(jnp.asarray(W, jnp.float32) for W in sysm.weights)
    x32 = jnp.asarray(np.random.default_rng(0).standard_normal(
        sysm.b_hat.shape), jnp.float32)
    y = jax.jit(lambda w, x: _stencil_apply(sysm.offsets, w, x, 3, 3))(
        w32, x32)
    y64 = np_stencil_apply(
        {o: np.asarray(w, np.float64) for o, w in zip(sysm.offsets, w32)},
        np.asarray(x32, np.float64), 3, 3)
    err = float(np.abs(np.asarray(y, np.float64) - y64).max()
                / np.abs(y64).max())
    log(f"[precision] f32 stencil apply {sysm.b_hat.shape}: max error "
        f"{err:.2e} of max |y|")
    check(err <= 1e-6, "f32 stencil apply within 1e-6 of float64")
    return err


def df32_precision(n=1_000_000, cells=(64, 32, 32)) -> None:
    """The double-float32 pair arithmetic under jit against float64:
    ``split_f64`` and ``df_scale_add`` to 2⁻⁴⁸ on ``n`` random values, and
    the pair defect of a random ``cells`` stencil system to f32 rounding of
    the residual itself, though its terms cancel to 1e-9."""
    import jax
    import jax.numpy as jnp

    from pde_solver.ops import df32
    from pde_solver.ops.linsolve import np_stencil_apply

    rng = np.random.default_rng(1)
    x64 = rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))
    d = (rng.standard_normal(n)
         * np.exp(rng.uniform(-20, 20, n))).astype(np.float32)
    ulp48 = 2.0 ** -48
    hi, lo = jax.jit(df32.split_f64)(jnp.asarray(x64))
    err = np.abs(df32.df_to_f64(hi, lo) - x64) / np.abs(x64)
    check(float(err.max()) <= ulp48, "split_f64 to 2^-48")
    hi, lo = df32.df_from_f64(x64)
    alpha = np.float32(0.7)
    got = df32.df_to_f64(*jax.jit(df32.df_scale_add)(hi, lo, alpha, d))
    scale = np.abs(df32.df_to_f64(hi, lo)) + np.abs(np.float64(alpha) * d)
    want = df32.df_to_f64(hi, lo) + np.float64(alpha) * d.astype(np.float64)
    check(float((np.abs(got - want) / scale).max()) <= 2 * ulp48,
          "df_scale_add to 2^-48")

    # a defect whose terms cancel: x solves A x = b to 1e-9
    shape = tuple(c + 1 for c in cells) + (3,)
    offsets = ((-1, 0, 0), (0, 0, 0), (1, 0, 0))
    W = [rng.standard_normal(shape + (3,)) for _ in offsets]
    x = rng.standard_normal(shape)
    b = np_stencil_apply(dict(zip(offsets, W)), x, 3, 3) * (1 + 1e-9)
    pairs = [df32.df_from_f64(a) for a in (b, x)]
    Wp = [df32.df_from_f64(w) for w in W]
    r, _ = df32.jit_df_residual(
        offsets, tuple(jnp.asarray(p[0]) for p in Wp),
        tuple(jnp.asarray(p[1]) for p in Wp), *map(jnp.asarray, pairs[0]),
        *map(jnp.asarray, pairs[1]), 3, 3)
    W64 = [df32.df_to_f64(*p) for p in Wp]
    r64 = df32.df_to_f64(*pairs[0]) - np_stencil_apply(
        dict(zip(offsets, W64)), df32.df_to_f64(*pairs[1]), 3, 3)
    rel = float(np.abs(np.asarray(r, np.float64) - r64).max()
                / np.abs(r64).max())
    check(rel <= 2.0 ** -22, "pair defect to f32 rounding of the residual")
    log(f"[precision] df32 split/scale_add within 2^-48 on {n} values; "
        f"pair defect error {rel:.2e} of max |r| (terms cancel to 1e-9)")


# ----------------------------------------------------------------------
# Phase 7 — the finest-level apply against the in-run copy bandwidth
# ----------------------------------------------------------------------

def apply_bandwidth(sysm, heat_n=128) -> None:
    """XLA apply of a prepared system (the flagship's fine level) and of the
    ``heat_n``³ heat operator, against the in-run copy bandwidth."""
    import jax.numpy as jnp

    from benchmarks.spmv_bench import (apply_report, copy_bandwidth,
                                       heat_system)

    copy_bps = copy_bandwidth()
    log(f"[apply] device copy: {copy_bps / 1e9:.1f} GB/s")
    cases = [("flagship fine level, vdim 3", sysm, 3),
             (f"heat {heat_n}³, vdim 1", heat_system(heat_n), 1)]
    for label, s, vdim in cases:
        rep = apply_report(s.offsets,
                           tuple(jnp.asarray(W, jnp.float32)
                                 for W in s.weights),
                           jnp.asarray(s.b_hat, jnp.float32), 3, vdim,
                           copy_bps=copy_bps)
        log(f"[apply] XLA {label}: {rep['apply_ms']:.4f} ms, "
            f"{rep['bytes'] / 1e6:.1f} MB, {rep['bytes_per_s'] / 1e9:.1f} "
            f"GB/s = {rep['share_of_copy'] * 100:.1f}% of copy, "
            f"share of published peak {rep['share_of_peak']}")
    log("[apply] decision: the plain XLA apply (no hand-written kernel; "
        "see PERF.md)")


# ----------------------------------------------------------------------
# Four cards — the sharded path and its one-card comparison
# ----------------------------------------------------------------------

@contextlib.contextmanager
def record_shard_spans():
    """Record how many devices each sharded MG solve and sharded transient
    scan really spanned."""
    from pde_solver.parallel import shard, shard_mg

    spans = []
    solve_inner = shard_mg.ShardedMGSolver.solve
    run_inner = shard.ShardedThetaScan.run

    def solve(self, *a, **kw):
        out = solve_inner(self, *a, **kw)
        spans.append(("mg", len(out[0].sharding.device_set)))
        return out

    def run(self, *a, **kw):
        out = run_inner(self, *a, **kw)
        spans.append(("scan", len(out[0].sharding.device_set)))
        return out

    shard_mg.ShardedMGSolver.solve = solve
    shard.ShardedThetaScan.run = run
    try:
        yield spans
    finally:
        shard_mg.ShardedMGSolver.solve = solve_inner
        shard.ShardedThetaScan.run = run_inner


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def sharded_flagship(cells=FLAGSHIP_CELLS, n_dev=4) -> float:
    """The flagship through ``solve_stencil_system`` sharded over ``n_dev``
    cards (float64 MG-PCG under ``mixed``) against the float64 MG-PCG solve
    of the same system on one card."""
    from benchmarks.spmv_bench import cantilever_problem
    from pde_solver.config import config_overrides
    from pde_solver.ops.linsolve import solve_stencil_system

    mesh, K, bc, b, builder = cantilever_problem(cells)
    out = {}
    for label, n in (("one card", 0), (f"{n_dev} cards", n_dev)):
        prec = "f64" if n == 0 else "mixed"
        with config_overrides(shard_devices=n, precision=prec), \
                record_shard_spans() as sp:
            t0 = time.perf_counter()
            x, st = solve_stencil_system(K, mesh, bc, b, vdim=3,
                                         mg_level_builder=builder)
            wall = time.perf_counter() - t0
        log(f"[sharded] flagship {label}: {wall:.3f} s, iterations "
            f"{int(st.iterations)}, relres {float(st.relative_residual):.3e}"
            f", device spans {sorted(set(sp))}")
        check(bool(st.converged), f"flagship {label} converged")
        if n:
            check(bool(sp) and all(k == n for _, k in sp),
                  f"sharded solves span {n} devices")
        out[n] = x
    err = _rel(out[n_dev], out[0])
    log(f"[sharded] flagship {n_dev} cards vs one card: relative L2 "
        f"{err:.3e}")
    check(err <= PARITY_TOL, f"sharded flagship within {PARITY_TOL}")
    return err


def sharded_transient(n=128, num_steps=10, n_dev=4) -> float:
    from pde_solver.config import config_overrides
    from pde_solver.mesh import box_mesh
    from pde_solver.models import heat

    p = heat.HeatProblem(
        mesh=box_mesh(n, n, n, (0, 0, 0), (1.0, 1.0, 1.0)), diffusivity=1.0,
        bc_builder=lambda m: [(m.boundary_mask(), 0.0)],
        T_initial=20.0, dt=0.01, num_steps=num_steps)
    out = {}
    for label, k in (("one card", 0), (f"{n_dev} cards", n_dev)):
        with config_overrides(shard_devices=k), record_shard_spans() as sp:
            _, values, info = heat.solve_heat_problem(p)
        scan = info.get("scan_seconds") or info["solve_seconds"]
        log(f"[sharded] heat {n}³ {label}: {num_steps / scan:.1f} steps/s "
            f"(scan {scan:.3f} s), device spans {sorted(set(sp))}")
        if k:
            check(bool(sp) and all(s == k for _, s in sp),
                  f"sharded scan spans {k} devices")
        out[k] = values
    err = _rel(out[n_dev], out[0])
    log(f"[sharded] heat {n}³ {n_dev} cards vs one card: relative L2 "
        f"{err:.3e}")
    check(err <= PARITY_TOL, f"sharded transient within {PARITY_TOL}")
    return err


# ----------------------------------------------------------------------

def result_line(devs, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)
    os.chdir(REPO)
    t_start = time.perf_counter()

    card_identity()
    if args.four_cards:
        devs = require_gpu(4)
        check(len(devs) == 4, "exactly four cards")
        sharded_flagship()
        sharded_transient()
        count = 4
    else:
        served_path()
        devs = require_gpu(1)
        sysm = flagship()
        parity()
        transient()
        stencil_precision(sysm)
        df32_precision()
        apply_bandwidth(sysm)
        count = 1
    log(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(result_line(devs, count), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
