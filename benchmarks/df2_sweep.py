"""Flagship df2 inner_iters sweep: is 14 the right per-correction budget?

The fused F-cycle round (`_jit_round_df`) runs mg_pcg corrections with a
static inner-iteration budget; the flagship converges in 4 rounds x ~126
inner iterations at inner_iters=14 (504 total, 0.72-0.86 s).  Fewer inner
iterations might converge in more-but-cheaper rounds (or expose that the
last round is mostly wasted); more might save a whole round.  Each value is
its own compiled program (static arg), so: compile+warm every config first,
then interleave timed reps round-robin (drift-robust, same worker —
cs_ab.py methodology).

Run on the real chip from /root/repo after a bench run has populated the
spec fast path (benchspec + hierarchy disk entries):
    python benchmarks/df2_sweep.py
    PDE_SWEEP_INNER=10,14,18 python benchmarks/df2_sweep.py
"""

import ast
import json
import os
import sys
import time

sys.path.insert(0, ".")  # run from the repository root


def main():
    import jax.numpy as jnp
    import numpy as np

    from pde_solver.ops import multigrid as mg
    from pde_solver.ops.linsolve import ScaledSystem
    from pde_solver.utils import diskcache

    t0 = time.perf_counter()
    float(jnp.zeros(()))
    print(f"[sweep] channel warmup {time.perf_counter() - t0:.1f}s",
          flush=True)

    cells = (160, 64, 64)
    E, nu = 210e9, 0.3
    speckey = ("elasticity3d-cantilever-v1", cells, E, nu,
               (0.0, 0.0, -9.81 * 7800.0))
    spec = diskcache.load("benchspec", speckey)
    if spec is None:
        raise SystemExit("no benchspec disk entry — run bench.py once first")
    ckey = ast.literal_eval(spec["meta"]["ckey"])
    t0 = time.perf_counter()
    h = mg.load_hierarchy_from_disk(ckey, 3, jnp.float32)
    sysm = ScaledSystem(ckey[2], None, spec["b_hat"], spec["gvals"],
                        spec["free"], "block", None, None, spec["CinvT"],
                        ckey=ckey)
    print(f"[sweep] hierarchy disk rebuild {time.perf_counter() - t0:.1f}s "
          f"({len(h.levels)} levels)", flush=True)
    t0 = time.perf_counter()
    ladder = mg.build_df_ladder(h, sysm, sysm.b_hat)
    print(f"[sweep] ladder {time.perf_counter() - t0:.1f}s", flush=True)
    bnorm = max(float(np.linalg.norm(
        np.asarray(sysm.b_hat, np.float64).reshape(-1))), 1e-300)

    inners = [int(v) for v in
              os.environ.get("PDE_SWEEP_INNER", "10,14,18,22").split(",")]
    # optional Chebyshev-degree sweep: "pre:post,pre:post,..." — rebuilds
    # the hierarchy struct (same device arrays, new static pre/post)
    smooth = os.environ.get("PDE_SWEEP_SMOOTH", "")
    if smooth:
        configs = []
        for token in smooth.split(","):
            pre, post = (int(x) for x in token.split(":"))
            for inner in inners:
                configs.append((inner, pre, post))
    else:
        configs = [(i, h.pre_smooth, h.post_smooth) for i in inners]
    tol = 1e-7

    def solve(cfgt):
        inner, pre, post = cfgt
        hh = (h if (pre, post) == (h.pre_smooth, h.post_smooth)
              else mg.MGHierarchy(h.levels, h.grid_dim, h.vdim, pre, post,
                                  h.coarse_iters))
        t = time.perf_counter()
        _, _, iters, relres = mg.solve_fcycle_df2(
            hh, ladder, tol, inner_iters=inner, max_rounds=12, bnorm=bnorm)
        return time.perf_counter() - t, int(iters), float(relres)

    # pass 1: compile + warm each config
    for cfgt in configs:
        dt, iters, relres = solve(cfgt)
        print(f"[sweep] warm {cfgt}: {dt:.1f}s (incl. compile) "
              f"iters={iters} relres={relres:.2e}", flush=True)

    # pass 2: interleaved timed reps
    results = {c: [] for c in configs}
    meta = {}
    for rnd in range(3):
        for cfgt in configs:
            dt, iters, relres = solve(cfgt)
            results[cfgt].append(dt)
            meta[cfgt] = (iters, relres)
            print(f"[sweep] rnd{rnd} {cfgt}: {dt:.3f}s "
                  f"iters={iters} relres={relres:.2e}", flush=True)

    out = {str(c): {"best_s": min(v), "all_s": [round(x, 3) for x in v],
                    "iters": meta[c][0], "relres": meta[c][1]}
           for c, v in results.items()}
    print(json.dumps(out, indent=2), flush=True)


if __name__ == "__main__":
    main()
