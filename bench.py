#!/usr/bin/env python
"""Benchmark harness — prints ONE JSON line.

Headline metric (BASELINE.md config 5): 3D static elasticity on a
1 m × 0.2 m × 0.2 m cantilever under gravity at ~2M DOF — wall time of the
solve (mixed-precision MG-PCG with double-f32 refinement) on one
accelerator.  ``vs_baseline`` = measured reference-class cost / measured
seconds (benchmarks/reference_baseline.py — fresh-LU per call for the small
configs, charitable cold Jacobi-CG for the large 3D ones).

Process layout:

* the default entry point is a PARENT that never imports JAX and runs the
  real bench as one child process at a time under a TOTAL wall budget
  (PDE_BENCH_DEADLINE, default 1380 s); crash retries walk a solver
  fallback chain (df2 fused F-cycle → host-driven df F-cycle → plain f32
  MG-PCG) with the remainder;
* the child BANKS metric lines progressively (a provisional compile-
  inclusive line after the warm-up solve, upgraded after every timed rep);
  the parent keeps a killed child's last banked line;
* a solve whose residual diverged is never banked.

The heavy host-side setup (prepare_system, MG hierarchy, df ladder) is
disk-cached content-keyed (utils.diskcache), so retries and later runs skip
most pre-solve work.

Methodology: the bench runs the full solve once to populate jit caches and
device-resident operators, then times fresh solves (from x=0) of the same
system, reporting the best of two.

Secondary metrics via PDE_BENCH_CONFIG:
  heat3d     backward-Euler steps/s, 3D heat 64³ cells (275k DOF)
  heat1d     BASELINE config 1: 1D rod 256 nodes, BE steps/s
  bar1d      BASELINE config 2: 1D bar static solve wall time (pure host —
             runs on the CPU backend)
  heat2d_cn  BASELINE config 3: 2D 128² plate, Crank–Nicolson steps/s
  elast2d    BASELINE config 4: 2D plane stress, solve wall time / MDOF/s
  spmv       finest-level stencil apply: ms, bytes/s against the copy
             bandwidth measured in the same run

Env knobs: PDE_BENCH_SCALE=small|medium|full|xl (default from
``config.backend_policy``: full on an accelerator; xl = 128³ heat3d, crosses
the transient-MG threshold), PDE_BENCH_CONFIG (above),
PDE_BENCH_SOLVER=df2|df|mgf32, PDE_BENCH_NO_WRAP=1 (run the child logic
directly, no parent), PDE_TRACE_DIR (capture a jax.profiler trace around the
timed solve).
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def emit(obj):
    """The one driver-visible JSON line."""
    print(json.dumps(obj), flush=True)


# ======================================================================
# Measured reference-class denominators (VERDICT r3 item 3)
#
# Every ``vs_baseline`` below divides by a MEASURED number from
# benchmarks/reference_baseline.py: fresh scipy-SuperLU solves of the SAME
# discrete system for the small configs (the reference's FEniCS
# ``solve(a == L)`` re-factorizes every call, fenics_mcp_server.py:309-318),
# and a charitable cold Jacobi-CG for the large 3D configs where a literal
# fresh-LU denominator is astronomically slow (fresh-LU ladders + power-law
# fits are recorded in reference_baseline.json for audit).  The constants
# here are a fallback snapshot; the JSON, when present, wins.
# ======================================================================

_REF_BASELINE_FALLBACK = {
    "heat1d_steps_per_s": 5448.7,       # fresh spsolve per BE step, 256 nodes
    "bar1d_solve_ms": 0.15,             # fresh spsolve, fixed-free 1D K
    "heat2d_steps_per_s": 8.77,         # fresh spsolve per CN step, 128²
    "elast2d_solve_ms": 4979.4,         # fresh spsolve, 256² plane stress
    "elast3d_2M_iterative_solve_s": 671.5,   # cold Jacobi-CG, rtol 1e-6
    # (num_nodes, steps/s) cold Jacobi-CG BE-step points → power-law fit
    "heat3d_iter_points": ((65 ** 3, 1.867), (129 ** 3, 0.0604)),
}


def ref_baseline():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmarks", "reference_baseline.json")
    vals = dict(_REF_BASELINE_FALLBACK)
    try:
        with open(path) as f:
            data = json.load(f)
        for k in ("heat1d_steps_per_s", "bar1d_solve_ms",
                  "heat2d_steps_per_s", "elast2d_solve_ms",
                  "elast3d_2M_iterative_solve_s"):
            vals[k] = data[k]["value"]
        vals["heat3d_iter_points"] = (
            (65 ** 3, data["heat3d_64cubed_iterative_steps_per_s"]["value"]),
            (129 ** 3, data["heat3d_128cubed_iterative_steps_per_s"]["value"]))
    except Exception as e:
        log(f"[bench] reference_baseline.json unreadable "
            f"({type(e).__name__}) — using the snapshot constants")
    return vals


def _heat3d_iter_alpha(vals):
    import math
    (n1, s1), (n2, s2) = vals["heat3d_iter_points"]
    return math.log(s1 / s2) / math.log(n2 / n1)


def heat3d_ref_steps_per_s(num_nodes):
    """Reference-class (cold Jacobi-CG) BE steps/s at this mesh size:
    measured directly at 65³/129³ nodes, power-law interpolated elsewhere
    (fitted exponent ≈1.7 — CG iteration growth × per-iteration cost)."""
    vals = ref_baseline()
    (n1, s1), _ = vals["heat3d_iter_points"]
    return s1 * (n1 / num_nodes) ** _heat3d_iter_alpha(vals)


def elast3d_ref_seconds(ndof):
    """Reference-class (cold Jacobi-CG) solve seconds for the cantilever:
    measured at the flagship's exact 2,040,675-DOF system; off-size runs
    (small/medium CPU smoke scales) reuse the heat-iterative exponent."""
    vals = ref_baseline()
    ref_ndof = 3 * 161 * 65 * 65
    return vals["elast3d_2M_iterative_solve_s"] * (
        ndof / ref_ndof) ** _heat3d_iter_alpha(vals)


# ======================================================================
# Parent: crash/timeout isolation + solver fallback chain
# ======================================================================

def _attempt_plan(cfg_name):
    """[(extra_env, timeout_cap_s), ...] — fallback env chain.  The caps are
    UPPER bounds; :func:`run_parent` shrinks each attempt to the wall budget
    actually left under PDE_BENCH_DEADLINE."""
    if cfg_name == "elasticity3d":
        return [({"PDE_BENCH_SOLVER": os.environ.get("PDE_BENCH_SOLVER",
                                                     "df2")}, 1320),
                ({"PDE_BENCH_SOLVER": "df"}, 600),
                ({"PDE_BENCH_SOLVER": "mgf32"}, 420)]
    if cfg_name == "bar1d":
        # pure-host path: the child needs no accelerator client
        env = {"JAX_PLATFORMS": "cpu"}
        return [(env, 600), (env, 600)]
    return [({}, 1320), ({}, 600)]


def run_parent():
    """Deadline-aware attempt loop.

    The parent treats PDE_BENCH_DEADLINE (default 1380 s) as the TOTAL wall
    budget and never imports JAX, so only one process at a time holds the
    device:

    * the FIRST child gets nearly all of it;
    * later attempts (child crashed early) get whatever time is left;
    * the child BANKS metric lines progressively (provisional after the
      warm-up solve, upgraded after each timed rep), and the parent emits the
      last banked line from a killed child rather than discarding it.
    """
    t_start = time.monotonic()
    deadline = t_start + float(os.environ.get("PDE_BENCH_DEADLINE", "1380"))
    cfg_name = os.environ.get("PDE_BENCH_CONFIG", "elasticity3d")
    plan = _attempt_plan(cfg_name)
    banked = None
    for i, (extra_env, cap_s) in enumerate(plan):
        remaining = deadline - time.monotonic()
        if remaining < 150:
            log(f"[bench] only {remaining:.0f}s of budget left — "
                f"skipping attempt {i + 1}")
            break
        timeout_s = int(min(cap_s, remaining - 40))
        env = dict(os.environ)
        env.update(extra_env)
        env["PDE_BENCH_CHILD"] = "1"
        env["PDE_BENCH_CHILD_BUDGET"] = str(max(timeout_s - 10, 60))
        log(f"[bench] attempt {i + 1}/{len(plan)} config={cfg_name} "
            f"env={extra_env} timeout={timeout_s}s "
            f"(budget left {remaining:.0f}s)")
        try:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__)],
                stdout=subprocess.PIPE, stderr=None, text=True, env=env,
                cwd=os.path.dirname(os.path.abspath(__file__)))
        except OSError as e:
            log(f"[bench] spawn failed: {e}")
            continue
        stdout_text = ""
        killed = False
        try:
            stdout_text, _ = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            killed = True
            log(f"[bench] attempt {i + 1} timed out after {timeout_s}s — "
                f"killing child pid {proc.pid}")
            proc.kill()
            try:
                stdout_text, _ = proc.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                stdout_text = ""
        result_line = None
        for line in (stdout_text or "").splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    parsed = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "metric" in parsed:
                    result_line = line  # keep the LAST (best) banked line
                    continue
            if line:
                log(f"[bench child stdout] {line}")
        if result_line is not None:
            banked = result_line
            if not killed and proc.returncode == 0:
                print(banked, flush=True)
                return 0
            log(f"[bench] attempt {i + 1} banked a metric before "
                f"{'timeout' if killed else f'rc={proc.returncode}'} — kept")
        log(f"[bench] attempt {i + 1} "
            f"{'killed' if killed else f'exited rc={proc.returncode}'}"
            + ("" if banked else " with no metric")
            + ("; retrying with fallback" if i + 1 < len(plan) else ""))
    if banked is not None:
        print(banked, flush=True)
        return 0
    log("[bench] all attempts failed — no metric to report")
    return 1


# Child-side wall budget (set by the parent): emit early, skip optional work
# near the end rather than losing the whole attempt to the parent's kill.
_CHILD_T0 = time.monotonic()


def child_time_left():
    budget = os.environ.get("PDE_BENCH_CHILD_BUDGET")
    if not budget:
        return float("inf")
    return float(budget) - (time.monotonic() - _CHILD_T0)


# ======================================================================
# Child-side helpers
# ======================================================================

# ======================================================================
# Secondary configs
# ======================================================================

def bench_heat3d():
    """Transient 3D heat: backward-Euler steps/s (BASELINE 'steps/s' metric)."""
    from pde_solver.config import backend_policy
    from pde_solver.mesh import box_mesh
    from pde_solver.models import heat

    scale = os.environ.get("PDE_BENCH_SCALE", backend_policy().bench_scale)
    # xl (128³ ≈ 2.1M DOF) crosses transient_mg_threshold → MG-PCG steps
    cells = {"small": 16, "medium": 40, "full": 64, "xl": 128}[scale]
    num_steps = 50

    mesh = box_mesh(cells, cells, cells, (0, 0, 0), (1.0, 1.0, 1.0))
    log(f"[bench] heat3d transient: {cells}³ cells, {mesh.num_nodes} DOF, "
        f"{num_steps} backward-Euler steps")
    p = heat.HeatProblem(
        mesh=mesh, diffusivity=1.0,
        bc_builder=lambda m: [(m.boundary_mask(), 0.0)],
        T_initial=20.0, dt=0.01, num_steps=num_steps)

    ref_steps_s = heat3d_ref_steps_per_s((cells + 1) ** 3)

    def metric_line(steps_s, **extra):
        out = {
            "metric": f"heat3d_{cells}cubed_backward_euler_steps_per_s",
            "value": round(steps_s, 2),
            "unit": "steps/s",
            # measured: cold Jacobi-CG BE step of the same system
            "vs_baseline": round(steps_s / ref_steps_s, 3),
        }
        out.update(extra)
        return out

    t0 = time.perf_counter()
    _, _, info = heat.solve_heat_problem(p)
    warmup_scan_s = info.get("scan_seconds") or info["solve_seconds"]
    log(f"[bench] warm-up run (incl. compile): {time.perf_counter() - t0:.1f}s "
        f"iters={info['cg_iterations']} relres={info['relative_residual']:.1e}")
    # bank a provisional line (parent keeps a killed child's last metric)
    emit(metric_line(num_steps / warmup_scan_s,
                     provisional="warmup_scan_includes_compile"))
    # best of 2 post-compile runs
    scans = []
    fetches = []
    for rep in range(2):
        t0 = time.perf_counter()
        times, values, info = heat.solve_heat_problem(p)
        total = time.perf_counter() - t0
        scan_s = info.get("scan_seconds") or info["solve_seconds"]
        scans.append(scan_s)
        fetches.append(info.get("fetch_seconds", 0.0))
        log(f"[bench] timed[{rep}]: total={total:.2f}s scan={scan_s:.2f}s "
            f"setup={info.get('setup_seconds', 0.0):.2f}s "
            f"fetch={info.get('fetch_seconds', 0.0):.2f}s "
            f"(CG iters total {info['cg_iterations']}, "
            f"relres {info['relative_residual']:.1e})")
        emit(metric_line(num_steps / min(scans)))  # bank best-so-far
        if child_time_left() < 120:
            log("[bench] child budget nearly spent — skipping further reps")
            break
    steps_s = num_steps / min(scans)
    log(f"[bench] → {steps_s:.1f} steps/s (best of {len(scans)})")
    fetch_s = min(fetches)
    emit(metric_line(steps_s, fetch_seconds=round(fetch_s, 2)))


def bench_heat1d():
    """BASELINE config 1: 2 m rod, 256 nodes, 20→0 °C, backward Euler."""
    from pde_solver.mesh import interval_mesh
    from pde_solver.models import heat

    num_steps = 400
    p = heat.HeatProblem(
        mesh=interval_mesh(255, 0.0, 2.0), diffusivity=1.0,
        bc_builder=lambda m: [(m.face_mask(0, 0), 20.0),
                              (m.face_mask(0, 1), 0.0)],
        T_initial=0.0, dt=0.05, num_steps=num_steps)
    heat.solve_heat_problem(p)  # compile
    _, values, info = heat.solve_heat_problem(p)
    steps_s = num_steps / (info.get("scan_seconds") or info["solve_seconds"])
    x = np.linspace(0.0, 2.0, 256)
    err = float(np.linalg.norm(values[-1] - 20.0 * (1 - x / 2.0))
                / np.linalg.norm(20.0 * (1 - x / 2.0)))
    log(f"[bench] heat1d: {steps_s:.0f} steps/s, steady-limit relL2={err:.1e}")
    emit({
        "metric": "heat1d_256nodes_backward_euler_steps_per_s",
        "value": round(steps_s, 1), "unit": "steps/s",
        # measured: fresh spsolve of (M+dtK) per step
        "vs_baseline": round(steps_s / ref_baseline()["heat1d_steps_per_s"], 3),
    })


def bench_bar1d():
    """BASELINE config 2: 2 m aluminum bar, fixed-free, static KU=F.

    Runs on the CPU backend (parent sets JAX_PLATFORMS=cpu): the solve is a
    pure-host sparse LU, so the child needs no accelerator client."""
    import jax

    from pde_solver.models.elasticity import solve_bar_1d

    solve_bar_1d(2.0, 255, 70e9, 0.01, 500.0)  # warm caches
    ms = np.inf
    for _rep in range(3):
        t0 = time.perf_counter()
        x, field, info = solve_bar_1d(2.0, 255, 70e9, 0.01, 500.0)
        ms = min(ms, (time.perf_counter() - t0) * 1e3)
    exact = 500.0 * (2.0 - x) / 0.01
    err = float(np.abs(field[10:-10] - exact[10:-10]).max() / exact.max())
    log(f"[bench] bar1d: {ms:.1f} ms/solve (backend={jax.default_backend()}), "
        f"interior stress err={err:.1e}")
    emit({
        "metric": "bar1d_256nodes_static_solve_ms",
        "value": round(ms, 2), "unit": "ms",
        # VERDICT r4 weak #6: the config-2 denominator (fresh spsolve of a
        # tridiagonal system, 0.15 ms) is near-free, so a speed RATIO at
        # this size is noise — the record is the wall time itself.  The
        # ratio is kept only as an explicitly-labeled informational field.
        "vs_baseline": None,
        "vs_baseline_note": "denominator near-free (tridiagonal LU 0.15 ms);"
                            " wall-time is the record for this config",
        "informational_ratio": round(
            ref_baseline()["bar1d_solve_ms"] / ms, 3),
    })


def bench_heat2d_cn():
    """BASELINE config 3: 1 m² plate, 128² mesh, Crank–Nicolson stepping."""
    from pde_solver.mesh import rectangle_mesh
    from pde_solver.models import heat

    num_steps = 50
    p = heat.HeatProblem(
        mesh=rectangle_mesh(128, 128, (0.0, 0.0), (1.0, 1.0)),
        diffusivity=1.0, bc_builder=lambda m: [(m.boundary_mask(), 0.0)],
        T_initial=20.0, dt=0.001, num_steps=num_steps, theta=0.5)
    heat.solve_heat_problem(p)  # compile
    _, values, info = heat.solve_heat_problem(p)
    steps_s = num_steps / (info.get("scan_seconds") or info["solve_seconds"])
    log(f"[bench] heat2d CN: {steps_s:.1f} steps/s "
        f"(iters {info['cg_iterations']}, relres {info['relative_residual']:.1e})")
    emit({
        "metric": "heat2d_128sq_crank_nicolson_steps_per_s",
        "value": round(steps_s, 2), "unit": "steps/s",
        # measured: fresh spsolve of (M+θdtK) per step
        "vs_baseline": round(steps_s / ref_baseline()["heat2d_steps_per_s"], 3),
    })


def bench_elast2d():
    """BASELINE config 4: 1 m² steel plate, plane stress, clamped + load."""
    from pde_solver.mesh import rectangle_mesh
    from pde_solver.models.elasticity import solve_elasticity_nd

    mesh = rectangle_mesh(256, 256, (0.0, 0.0), (1.0, 1.0))
    body = np.array([0.0, -7.65e4])
    solve_elasticity_nd(mesh, 210e9, 0.3, body, "plane_stress")  # compile
    _, info = solve_elasticity_nd(mesh, 210e9, 0.3, body, "plane_stress")
    ms = info["solve_seconds"] * 1e3
    mdof = info["num_dofs"] * max(info["cg_iterations"], 1) / info["solve_seconds"] / 1e6
    log(f"[bench] elast2d 256²: {ms:.0f} ms/solve, {mdof:.0f} MDOF/s, "
        f"relres {info['relative_residual']:.1e}")
    emit({
        "metric": "elasticity2d_256sq_plane_stress_solve_ms",
        "value": round(ms, 1), "unit": "ms",
        # measured: fresh spsolve (SuperLU) of the same 132k-DOF system
        "vs_baseline": round(ref_baseline()["elast2d_solve_ms"] / ms, 3),
    })


def bench_spmv():
    """Finest-level stencil apply: ms/apply, bytes/s against the copy
    bandwidth measured in the same run and the published peak."""
    scale = os.environ.get("PDE_BENCH_SCALE", "full")
    cells = {"small": "32 16 16", "medium": "96 32 32",
             "full": "160 64 64", "xl": "256 128 64"}.get(scale, "160 64 64")
    out = subprocess.run(
        [sys.executable, "benchmarks/spmv_bench.py", *cells.split()],
        capture_output=True, text=True)
    log(out.stdout + out.stderr)


# ======================================================================
# Flagship: 2M-DOF 3D elasticity
# ======================================================================

def bench_flagship():
    import jax
    import jax.numpy as jnp

    from pde_solver.mesh import box_mesh
    from pde_solver.models.elasticity import lame_parameters, von_mises_fields
    from pde_solver.ops import assembly, multigrid as mg
    from pde_solver.ops.bc import DirichletBC
    from pde_solver.ops.linsolve import prepare_system

    from pde_solver.config import backend_policy

    backend = jax.default_backend()
    scale = os.environ.get("PDE_BENCH_SCALE", backend_policy().bench_scale)
    cells = {"small": (32, 16, 16), "medium": (96, 32, 32),
             "full": (160, 64, 64), "xl": (160, 64, 64)}[scale]
    cells_env = os.environ.get("PDE_BENCH_CELLS")
    if cells_env:
        # explicit mesh override for scaling studies ("224 96 96")
        cells = tuple(int(x) for x in cells_env.split())
    log(f"[bench] backend={backend} scale={scale} cells={cells}")

    E, nu = 210e9, 0.3
    lam, mu = lame_parameters(E, nu, "3d")
    mesh = box_mesh(*cells, (0, 0, 0), (1.0, 0.2, 0.2))
    ndof = mesh.num_nodes * 3
    log(f"[bench] nodes={mesh.num_nodes} DOF={ndof}")

    t_setup0 = time.perf_counter()

    # --- spec fast path: a prior run of this exact problem persisted the
    # prepared RHS/scales + the hierarchy's content key, so assembly AND
    # prepare_system can be skipped entirely (the hierarchy itself rebuilds
    # from its disk entry with device-side CS expansion — uploads only).
    from pde_solver.ops.linsolve import ScaledSystem
    from pde_solver.utils import diskcache

    speckey = ("elasticity3d-cantilever-v1", cells, E, nu,
               (0.0, 0.0, -9.81 * 7800.0))
    sysm = None
    h = None
    spec = diskcache.load("benchspec", speckey)
    if spec is not None:
        import ast
        try:
            ckey = ast.literal_eval(spec["meta"]["ckey"])
            h = mg.load_hierarchy_from_disk(ckey, 3, jnp.float32)
            if h is not None:
                sysm = ScaledSystem(
                    ckey[2], None, spec["b_hat"], spec["gvals"],
                    spec["free"], "block", None, None, spec["CinvT"],
                    ckey=ckey)
                log(f"[bench] spec fast path: assembly+prepare skipped, "
                    f"hierarchy rebuilt from disk "
                    f"({time.perf_counter() - t_setup0:.1f}s)")
        except Exception as e:
            log(f"[bench] spec fast path unusable ({type(e).__name__}: {e})")
            sysm = h = None

    if sysm is None:
        t0 = time.perf_counter()
        K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
        b = assembly.assemble_vector_load(mesh,
                                          np.array([0.0, 0.0, -9.81 * 7800.0]))
        bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                    mesh.node_shape, vdim=3)
        log(f"[bench] assembly: {time.perf_counter() - t0:.1f}s")

        t0 = time.perf_counter()
        sysm = prepare_system(K, mesh, bc, b, 3)
        log(f"[bench] prepare (mask+block-scale): "
            f"{time.perf_counter() - t0:.1f}s")

        def builder(mc):
            return (assembly.assemble_elasticity_stencil(mc, lam, mu),
                    DirichletBC.from_masks([(mc.face_mask(0, 0), 0.0)],
                                           mc.node_shape, vdim=3))

        t0 = time.perf_counter()
        h = mg.build_hierarchy_cached(mesh, sysm, builder, vdim=3,
                                      dtype=jnp.float32, cache_key=sysm.ckey)
        log(f"[bench] hierarchy build+upload ({len(h.levels)} levels): "
            f"{time.perf_counter() - t0:.1f}s")
        if sysm.ckey is not None:
            diskcache.store(
                "benchspec", speckey,
                {"b_hat": np.asarray(sysm.b_hat),
                 "gvals": np.asarray(sysm.gvals),
                 "free": np.asarray(sysm.free),
                 "CinvT": np.asarray(sysm.CinvT)},
                meta={"ckey": repr(sysm.ckey)})

    # V(2,1) cycle for the flagship df2 rounds (benchmarks/df2_sweep.py
    # compares cycles).  Same device arrays — only the static smoothing
    # degrees change.
    smooth = os.environ.get("PDE_BENCH_SMOOTH", "2,1")
    if smooth:
        pre_s, post_s = (int(x) for x in smooth.split(","))
        if (pre_s, post_s) != (h.pre_smooth, h.post_smooth):
            h = h._replace(pre_smooth=pre_s, post_smooth=post_s)
            log(f"[bench] MG cycle: V({pre_s},{post_s})")

    solver_start = os.environ.get("PDE_BENCH_SOLVER", "df2")
    ladder = None
    if solver_start != "mgf32":
        t0 = time.perf_counter()
        try:
            ladder = mg.build_df_ladder(h, sysm, sysm.b_hat)
            jax.block_until_ready(ladder.Whi)
            log(f"[bench] double-f32 ladder upload: "
                f"{time.perf_counter() - t0:.1f}s")
        except Exception as e:
            # df2/df need the ladder; mgf32 does not — degrade in-process
            log(f"[bench] ladder build failed ({type(e).__name__}: {e}) — "
                f"falling back to the mgf32 chain")
            solver_start = "mgf32"
    setup_s = time.perf_counter() - t_setup0
    log(f"[bench] total pre-solve setup: {setup_s:.1f}s "
        f"(child budget left {child_time_left():.0f}s)")

    bench_tol = float(os.environ.get("PDE_BENCH_TOL", 1e-7))
    # ‖b̂‖ from the HOST copy: the solver then dispatches its fused round
    # program without any device→host pull first.
    bnorm_host = max(float(np.linalg.norm(
        np.asarray(sysm.b_hat, np.float64).reshape(-1))), 1e-300)

    inner = int(os.environ.get("PDE_BENCH_INNER", 10))

    def solve_df2():
        x_hi, x_lo, iters, relres = mg.solve_fcycle_df2(
            h, ladder, bench_tol, inner_iters=inner, max_rounds=12,
            bnorm=bnorm_host)
        return (x_hi, x_lo), iters, relres

    def solve_df():
        x_hi, x_lo, iters, relres = mg.solve_fcycle_df(
            h, ladder, bench_tol, inner_iters=inner, max_rounds=12,
            bnorm=bnorm_host)
        return (x_hi, x_lo), iters, relres

    def solve_mgf32():
        """Last-resort fallback (df2 AND df unusable): f32 MG-PCG inner
        solves + host float64 residual refinement.  A bare f32 MG-PCG
        floors near κ·ε32 (measured 7.1e-3 relative on this cantilever);
        the host-refreshed rounds recover ~1e-7-grade residuals at the cost
        of a few single-core stencil applies."""
        from pde_solver.ops import df32 as _df32

        lv0 = h.levels[0]
        if lv0.host_weights is not None:
            lv_host = lv0
        elif lv0.host_pairs is not None:
            w64 = [np.asarray(hi, np.float64) + np.asarray(lo)
                   for hi, lo in zip(*lv0.host_pairs)]
            lv_host = lv0._replace(host_weights=w64)
        else:  # CS disk rebuild carries the compact split, not f64 weights
            wc_hi, wc_lo, shi, slo = lv0.host_cs
            ns = tuple(int(s) for s in lv0.free.shape[:3])
            hi = mg._expand_cs_np(wc_hi, shi, ns, 3)
            lo = mg._expand_cs_np(wc_lo, slo, ns, 3)
            w64 = [hi[k].astype(np.float64) + lo[k]
                   for k in range(hi.shape[0])]
            lv_host = lv0._replace(host_weights=w64)
        b64 = np.asarray(sysm.b_hat, np.float64)
        bnorm = max(float(np.linalg.norm(b64.reshape(-1))), 1e-300)
        x64 = np.zeros_like(b64)
        total = 0
        relres = 1.0
        for _round in range(6):
            r = b64 - mg._host_apply(lv_host, x64, 3, 3)
            relres = float(np.linalg.norm(r.reshape(-1))) / bnorm
            if relres <= max(bench_tol, 1e-7):
                break
            scale = float(np.max(np.abs(r)))
            d32, k, _ = mg.solve_mg(h, (r / scale).astype(np.float32), None,
                                    1e-5, 200)
            x64 = x64 + scale * np.asarray(d32, np.float64)
            total += int(k)
        hi, lo = _df32.df_from_f64(x64)
        return (jnp.asarray(hi), jnp.asarray(lo)), total, relres

    chain = {"df2": [("df2", solve_df2), ("df", solve_df),
                     ("mgf32", solve_mgf32)],
             "df": [("df", solve_df), ("mgf32", solve_mgf32)],
             "mgf32": [("mgf32", solve_mgf32)]}[solver_start]

    from pde_solver.utils.observability import device_trace

    ref_seconds = elast3d_ref_seconds(ndof)

    def metric_line(value_s, kind, iters, relres, **extra):
        out = {
            "metric": "elasticity3d_cantilever_2MDOF_solve_seconds",
            "value": round(value_s, 3),
            "unit": "s",
            # measured: cold Jacobi-CG of the exact flagship system (671.5 s
            # at full scale) — the charitable reference class; the literal
            # reference behavior (fresh LU per call) extrapolates to ~3.8
            # DAYS at 2M DOF (reference_baseline.json fresh-LU ladder)
            "vs_baseline": round(ref_seconds / value_s, 3),
            "solver": kind,
            "relres": float(f"{relres:.3e}"),
            "setup_seconds": round(setup_s, 1),
        }
        out.update(extra)
        return out

    solver_used = None
    x_hat = None
    solve_s = float("inf")
    iters = 0
    relres = float("nan")
    for kind, solver in chain:
        # warm-up run (compiles)
        try:
            t0 = time.perf_counter()
            x_hat, iters, relres = solver()
            warmup_solve_s = time.perf_counter() - t0
            log(f"[bench] {kind} warm-up solve (incl. jit compile): "
                f"{warmup_solve_s:.1f}s  iters={iters} relres={relres:.2e}")
        except Exception as e:
            log(f"[bench] solver {kind} unusable ({type(e).__name__}: {e}) — "
                f"falling back")
            continue
        if not math.isfinite(relres) or relres > 1e-3:
            # a DIVERGED solve must never be banked as the flagship number
            # (r5 scaling study: df2 NaN'd at 9.8M DOF and the old code
            # reported relres=NaN with a huge vs_baseline) — fall through
            # to the next solver kind
            log(f"[bench] {kind} solve did not converge "
                f"(relres={relres!r}) — falling back")
            continue
        # BANK a provisional metric now: a real converged solve, wall time
        # compile-inclusive — if anything after this point hangs, the parent
        # still has a line to report.  Each timed rep below re-emits; the
        # parent keeps the LAST line.
        emit(metric_line(warmup_solve_s, kind, iters, relres,
                         provisional="warmup_includes_jit_compile"))
        # timed runs: best of 2
        ok = 0
        for rep in range(2):
            t0 = time.perf_counter()
            with device_trace("elasticity3d_solve"):
                x_hat, iters, relres = solver()
            rep_s = time.perf_counter() - t0
            log(f"[bench] timed solve[{rep}] ({kind}): {rep_s:.3f}s  "
                f"iters={iters} relres={relres:.2e}")
            if not math.isfinite(relres) or relres > 1e-3:
                log(f"[bench] timed rep diverged — not banking it")
                continue
            ok += 1
            solve_s = min(solve_s, rep_s)
            emit(metric_line(solve_s, kind, iters, relres))
            if child_time_left() < 60:
                log("[bench] child budget nearly spent — skipping further reps")
                break
        if ok > 0:
            solver_used = kind
            break
    if solver_used is None:
        log("[bench] every solver path failed — no timed measurement "
            "(a provisional warm-up line may already be banked)")
        raise SystemExit(3)

    mdof = ndof * max(iters, 1) / solve_s / 1e6
    log(f"[bench] throughput: {mdof:.0f} MDOF/s across MG-PCG iterations")

    # Finest-level apply bandwidth against the copy bandwidth measured in
    # this run.  Optional: the metric is already banked above.
    spmv = None
    if child_time_left() > 120 and backend != "cpu":
        spmv = _spmv_bandwidth(h, sysm)

    # physics sanity + postprocess timing (excluded from the metric)
    if child_time_left() > 60:
        try:
            t0 = time.perf_counter()
            from pde_solver.ops import df32 as _df
            x_np = _df.df_to_f64(np.asarray(x_hat[0]), np.asarray(x_hat[1]))
            log(f"[bench] solution retrieval: {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            u = sysm.from_hat_x(x_np)
            vm_stress, _ = von_mises_fields(mesh, u, lam, mu)
            log(f"[bench] postprocess: {time.perf_counter() - t0:.1f}s  "
                f"max von Mises={float(vm_stress.max()):.3e} Pa")
        except Exception as e:  # never let postprocess void the measurement
            log(f"[bench] postprocess skipped: {type(e).__name__}: {e}")

    extra = {}
    if spmv is not None:
        extra["spmv_share_of_copy"] = spmv["share_of_copy"]
        extra["spmv_share_of_peak"] = spmv["share_of_peak"]
    emit(metric_line(solve_s, solver_used, iters, relres, **extra))


def _spmv_bandwidth(h, sysm):
    import jax.numpy as jnp

    from benchmarks.spmv_bench import apply_report

    lv = h.levels[0]
    rep = apply_report(lv.offsets, lv.weights,
                       jnp.asarray(sysm.b_hat, jnp.float32), 3, 3)
    peak = rep["published_peak_bytes_per_s"]
    log(f"[bench] finest apply: {rep['apply_ms']:.3f} ms, "
        f"{rep['bytes'] / 1e6:.0f} MB, {rep['bytes_per_s'] / 1e9:.0f} GB/s = "
        f"{rep['share_of_copy'] * 100:.0f}% of the in-run copy "
        f"({rep['copy_bytes_per_s'] / 1e9:.0f} GB/s); published peak "
        f"{'unknown' if peak is None else f'{peak / 1e12:.2f} TB/s'} "
        f"for {rep['device_kind']}")
    return rep


def run_child():
    cfg_name = os.environ.get("PDE_BENCH_CONFIG", "elasticity3d")
    sub = {"heat3d": bench_heat3d, "heat1d": bench_heat1d,
           "bar1d": bench_bar1d, "heat2d_cn": bench_heat2d_cn,
           "elast2d": bench_elast2d, "spmv": bench_spmv}.get(cfg_name)
    if sub is not None:
        sub()
    else:
        bench_flagship()


def main():
    if (os.environ.get("PDE_BENCH_CHILD") == "1"
            or os.environ.get("PDE_BENCH_NO_WRAP") == "1"):
        run_child()
        return
    raise SystemExit(run_parent())


if __name__ == "__main__":
    main()
