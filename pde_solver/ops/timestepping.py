"""Implicit time stepping compiled as one ``lax.scan``.

Replaces the reference's Python time loop — which rebuilds the RHS form and
re-solves an unfactorized matrix every step and boxes every snapshot into
Python lists (fenics_mcp_server.py:309-318, :438-447, :707-716) — with a
single jit-compiled θ-scheme scan:

    (M + θ Δt K) u^{n+1} = (M − (1−θ) Δt K) u^n + Δt b

θ=1 is backward Euler (reference parity); θ=1/2 is Crank-Nicolson (new
capability, BASELINE.md config 3).  The implicit operator gets Dirichlet
masking and symmetric Jacobi scaling baked into its stencil weights on host
(see ops.linsolve); each step solves with warm-started CG on the scaled
unit-diagonal system.  Snapshots stack on device and transfer once.

The whole scan is compiled behind a module-level jit whose cache keys on
(offsets, shapes, num_steps, mode) — repeated transients on the same mesh
shape dispatch once.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pde_solver.config import SolverConfig, get_config
from pde_solver.mesh import StructuredMesh
from pde_solver.ops.bc import DirichletBC
from pde_solver.ops.stencil import block_matvec
from pde_solver.ops.linsolve import (
    _cg_unit_diag,
    _stencil_apply,
    np_stencil_apply,
    prepare_system,
)


class TransientResult(NamedTuple):
    values: np.ndarray        # [num_steps+1, *node_shape(, v)] float64 — u0 first
    times: np.ndarray         # [num_steps+1]
    total_cg_iterations: int
    max_relative_residual: float
    setup_seconds: float = 0.0  # host system prep + MG hierarchy build/upload
    scan_seconds: float = 0.0   # the jitted stepping scan itself (post-compile
                                # stepping throughput = num_steps/scan_seconds)
    fetch_seconds: float = 0.0  # trajectory device→host retrieval, kept
                                # out of scan_seconds: it is transfer, not
                                # stepping cost.  The checkpointed path
                                # interleaves per-chunk pulls with compute
                                # and reports them here in aggregate.


def _combine(K: Dict, M: Dict, alpha: float, beta: float) -> Dict:
    """beta*M + alpha*K as a numpy stencil."""
    out = {}
    for o, W in M.items():
        out[o] = beta * np.asarray(W, dtype=np.float64)
    for o, W in K.items():
        out[o] = out.get(o, 0.0) + alpha * np.asarray(W, dtype=np.float64)
    return out


def _make_scale_ops(s, Ct, CinvT):
    """Scaled-system coordinate changes, scalar (s) or block (Ct/CinvT).

    Scalar Jacobi: Â = S A S with S = diag(s) ⇒ b̂ = S b, x̂ = x/s, x = S x̂.
    Block Cholesky: Â = C⁻¹ A C⁻ᵀ ⇒ b̂ = C⁻¹ b, x̂ = Cᵀ x, x = C⁻ᵀ x̂.
    Block products go through :func:`ops.stencil.block_matvec`, which is
    exact f32 arithmetic on every backend."""
    if s is not None:
        return (lambda v: s * v), (lambda v: v / s), (lambda v: s * v)

    def to_hat_b(v):
        return block_matvec(jnp.swapaxes(CinvT, -1, -2), v)

    def to_hat_x(v):
        return block_matvec(Ct, v)

    def from_hat_x(v):
        return block_matvec(CinvT, v)

    return to_hat_b, to_hat_x, from_hat_x


@partial(jax.jit, static_argnames=("offsets", "num_steps", "maxiter",
                                   "refine", "grid_dim", "vdim", "mode",
                                   "snap32", "h_struct"))
def _transient_scan(offsets, A32, A64, B_w, free, g, s, Ct, CinvT, b_src,
                    Ag, u0, inner_tol, num_steps, maxiter, refine, grid_dim,
                    vdim, mode, snap32, h_struct=None, level_arrays=None,
                    tmod=None, step0=None, Cw=None, u_prev0=None):
    """One fused scan over implicit steps on the scaled system.

    mode: "f64" | "f32" | "mixed".  All weight tuples are aligned with
    ``offsets``; ``B_w`` is the unmasked explicit-side operator.  Scaling is
    scalar (``s``) for vdim=1 or block-Cholesky (``Ct``/``CinvT``) otherwise.
    With ``h_struct``/``level_arrays`` (a multigrid hierarchy of the
    implicit operator) each step solves with MG-PCG instead of plain CG —
    ~8× fewer inner iterations at 64³ and beyond.

    ``tmod`` (optional): sinusoidal time modulation of the source and/or
    Dirichlet data — (b1, g1, Ag1, omega, phase, dt, theta); see
    :func:`run_transient`.  ``step0``: global index of the first step
    (traced, so checkpoint chunks at different offsets share one compiled
    program); the carry tracks the step counter for the modulation phase.

    ``Cw`` (optional): dt-scaled convection stencil for CNAB2 — the carry
    gains the previous state and the explicit side subtracts the
    Adams-Bashforth-2 extrapolation Δt·(3/2 C uⁿ − 1/2 C uⁿ⁻¹).
    ``u_prev0`` seeds that history (None → u0, which makes the first step
    exactly AB1 — the standard self-starting bootstrap).
    """
    state_dtype = jnp.float64 if mode in ("f64", "mixed") else jnp.float32
    u0 = u0.astype(state_dtype)
    snap_dtype = jnp.float32 if snap32 else state_dtype

    def step(carry, _):
        carry, u_new = _transient_step_body(
            offsets, A32, A64, B_w, free, g, s, Ct, CinvT, b_src, Ag,
            inner_tol, maxiter, refine, grid_dim, vdim, mode, h_struct,
            level_arrays, carry, tmod, Cw)
        return carry, u_new.astype(snap_dtype)

    n0 = jnp.asarray(0 if step0 is None else step0, jnp.int32)
    carry0 = (u0, jnp.asarray(0, jnp.int32), jnp.asarray(0.0, state_dtype),
              n0)
    if Cw is not None:
        up0 = u0 if u_prev0 is None else u_prev0.astype(state_dtype)
        carry0 = (u0, up0) + carry0[1:]
        (u_f, _up, iters, res, _), snaps = jax.lax.scan(
            step, carry0, None, length=num_steps)
        return snaps, iters, res
    (u_f, iters, res, _), snaps = jax.lax.scan(step, carry0, None,
                                               length=num_steps)
    return snaps, iters, res


def _transient_step_body(offsets, A32, A64, B_w, free, g, s, Ct, CinvT,
                         b_src, Ag, inner_tol, maxiter, refine, grid_dim,
                         vdim, mode, h_struct, level_arrays, carry,
                         tmod=None, Cw=None):
    """One implicit θ-step on the scaled system (shared by the plain and
    snapshot-thinned scans).  Returns (new carry, u_new)."""
    state_dtype = jnp.float64 if mode in ("f64", "mixed") else jnp.float32
    to_hat_b, to_hat_x, from_hat_x = _make_scale_ops(s, Ct, CinvT)

    def B(x):
        return _stencil_apply(offsets, B_w, x, grid_dim, vdim)

    if Cw is not None:
        u, u_prev, iters_acc, res_acc, n = carry
    else:
        u, iters_acc, res_acc, n = carry
        u_prev = None
    if tmod is None:
        rhs = B(u) + b_src
        Ag_t, g_t = Ag, g
    else:
        # sinusoidal driving: b(t) = b0 + sin(ωt+φ)·b1 enters the θ-scheme
        # as dt·[θ s(t_{n+1}) + (1−θ) s(t_n)]·b1 (b1 arrives pre-scaled by
        # dt); Dirichlet data g(t) = g0 + sin(ωt+φ)·g1 is enforced at the
        # NEW time level, with the lift Ag(t) scaling identically.
        b1, g1, Ag1, omega, phase, dtv, thetav = tmod
        t_n = n.astype(state_dtype) * dtv
        s_n = jnp.sin(omega * t_n + phase)
        s_np1 = jnp.sin(omega * (t_n + dtv) + phase)
        w = thetav * s_np1 + (1.0 - thetav) * s_n
        rhs = B(u) + b_src + (w * b1 if b1 is not None else 0.0)
        Ag_t = Ag + (s_np1 * Ag1 if Ag1 is not None else 0.0)
        g_t = g + (s_np1 * g1 if g1 is not None else 0.0)
    if Cw is not None:
        # CNAB2: explicit Adams-Bashforth-2 extrapolation of the convection
        # term (Cw arrives pre-scaled by Δt); with u_prev seeded to u0 the
        # first step degenerates to AB1 — the standard bootstrap.
        def C(x):
            return _stencil_apply(offsets, Cw, x, grid_dim, vdim)

        rhs = rhs - (1.5 * C(u) - 0.5 * C(u_prev))
    bt = free * (rhs - Ag_t) + g_t
    b_hat = to_hat_b(bt)
    x0_hat = to_hat_x(u)

    hh = None
    if h_struct is not None:
        from pde_solver.ops import multigrid as mg
        hh = mg.hierarchy_from_arrays(h_struct, level_arrays)

    if hh is not None and mode != "mixed":
        # resync_every=0: the periodic true-residual refresh would lower
        # to a select inside the scan (one wasted apply per iteration);
        # warm-started per-step solves run ~5 iterations and never drift.
        xh, k, relres = mg.mg_pcg(hh, b_hat.astype(state_dtype),
                                  x0_hat.astype(state_dtype),
                                  inner_tol, maxiter, resync_every=0)
    elif mode == "f64":
        xh, k, relres = _cg_unit_diag(offsets, A64, b_hat, x0_hat,
                                      inner_tol, maxiter, grid_dim, vdim)
    elif mode == "f32":
        xh, k, relres = _cg_unit_diag(offsets, A32, b_hat, x0_hat,
                                      inner_tol, maxiter, grid_dim, vdim)
    else:  # mixed: f64 state, f32 corrections (CG or MG-PCG) of the f64
        # residual from the warm start
        def A64f(x):
            return _stencil_apply(offsets, A64, x, grid_dim, vdim)

        def correct(r32):
            zero = jnp.zeros(r32.shape, jnp.float32)
            if hh is not None:
                return mg.mg_pcg(hh, r32, zero, inner_tol, maxiter,
                                 resync_every=0)
            return _cg_unit_diag(offsets, A32, r32, zero, inner_tol,
                                 maxiter, grid_dim, vdim)

        xh = x0_hat
        k = jnp.asarray(0, jnp.int32)
        for _r in range(1 + refine):
            r = b_hat - A64f(xh)
            scale = jnp.maximum(jnp.max(jnp.abs(r)), 1e-300)
            d32, ki, _ = correct((r / scale).astype(jnp.float32))
            xh = xh + scale * d32.astype(jnp.float64)
            k = k + ki
        r = b_hat - A64f(xh)
        bn = jnp.maximum(jnp.sqrt(jnp.vdot(b_hat.reshape(-1),
                                           b_hat.reshape(-1))), 1e-300)
        relres = jnp.sqrt(jnp.vdot(r.reshape(-1), r.reshape(-1))) / bn

    u_new = from_hat_x(xh).astype(state_dtype)
    tail_carry = (iters_acc + k,
                  jnp.maximum(res_acc, relres.astype(state_dtype)), n + 1)
    if Cw is not None:
        return (u_new, u) + tail_carry, u_new
    return (u_new,) + tail_carry, u_new


@partial(jax.jit, static_argnames=("offsets", "num_steps", "maxiter",
                                   "refine", "grid_dim", "vdim", "mode",
                                   "snap32", "h_struct", "snap_every"))
def _transient_scan_thinned(offsets, A32, A64, B_w, free, g, s, Ct, CinvT,
                            b_src, Ag, u0, inner_tol, num_steps, maxiter,
                            refine, grid_dim, vdim, mode, snap32, h_struct,
                            level_arrays, snap_every, tmod=None, step0=None,
                            Cw=None, u_prev0=None):
    """Chunked scan: ``snap_every`` steps per emitted snapshot, so the
    stacked trajectory holds num_steps/snap_every frames instead of
    num_steps — the [Nt][N] snapshot buffer is what exceeds HBM for long
    transients at multi-M DOF (the plotter caps animations at ~30 frames
    anyway, matching the reference's fenics_mcp_server.py:3042-3048).
    num_steps must be divisible by snap_every (caller pads the step count).

    With ``Cw`` (CNAB2 convection, see :func:`_transient_scan`) the second
    return value is the final (u, u_prev) pair so chunked/checkpointed
    callers can reseed the AB2 history exactly.
    """
    def chunk(carry, _):
        def inner(c, _):
            c2, _snap = _transient_step_body(
                offsets, A32, A64, B_w, free, g, s, Ct, CinvT, b_src, Ag,
                inner_tol, maxiter, refine, grid_dim, vdim, mode, h_struct,
                level_arrays, c, tmod, Cw)
            return c2, None
        carry, _ = jax.lax.scan(inner, carry, None, length=snap_every)
        snap_dtype = jnp.float32 if snap32 else carry[0].dtype
        return carry, carry[0].astype(snap_dtype)

    state_dtype = jnp.float64 if mode in ("f64", "mixed") else jnp.float32
    n0 = jnp.asarray(0 if step0 is None else step0, jnp.int32)
    carry0 = (u0.astype(state_dtype), jnp.asarray(0, jnp.int32),
              jnp.asarray(0.0, state_dtype), n0)
    if Cw is not None:
        up0 = u0 if u_prev0 is None else u_prev0
        carry0 = (carry0[0], up0.astype(state_dtype)) + carry0[1:]
        (u_f, up_f, iters, res, _), snaps = jax.lax.scan(
            chunk, carry0, None, length=num_steps // snap_every)
        return snaps, (u_f, up_f), iters, res
    (u_f, iters, res, _), snaps = jax.lax.scan(
        chunk, carry0, None, length=num_steps // snap_every)
    return snaps, u_f, iters, res


@jax.jit
def _jit_cast_bf16(s):
    return s.astype(jnp.bfloat16)


@jax.jit
def _jit_thin_cast_bf16(s, idx):
    return s[idx].astype(jnp.bfloat16)


def _fetch_trajectory(snaps, cfg):
    """Bulk device→host trajectory pull with size-bounded reduction.

    Pulls larger than ``cfg.fetch_budget_bytes`` are thinned ON DEVICE to
    ``cfg.fetch_frames`` frames (the plotters cap animations at ~30 frames,
    viz/plots.py:33 — matching fenics_mcp_server.py:3042-3048) and cast to
    bfloat16 before the transfer.  bf16
    keeps the f32 exponent (no overflow on stress-scale fields) at ~0.4 %
    relative precision: visualization/summary grade.  The LAST frame is
    always kept.  Full precision stays available on request
    (``fetch_budget_bytes=0``).  Returns (values_f64, kept_idx or None)."""
    nbytes = snaps.size * snaps.dtype.itemsize
    budget = int(cfg.fetch_budget_bytes)
    if budget <= 0 or nbytes <= budget:
        return np.asarray(snaps, dtype=np.float64), None
    nt = int(snaps.shape[0])
    idx = None
    if cfg.fetch_frames > 0:
        # the budget BINDS: thin below the plot cap if the bf16 payload
        # still would not fit; never fewer than 2 kept frames
        per_frame_bf16 = (snaps.size // max(nt, 1)) * 2
        max_frames = min(int(cfg.fetch_frames),
                         max(2, budget // max(per_frame_bf16, 1)))
        if nt > max_frames:
            k = -(-nt // max_frames)
            idx = list(range(k - 1, nt, k))
            if idx[-1] != nt - 1:
                idx.append(nt - 1)
    if idx is None:
        sub = _jit_cast_bf16(snaps)
    else:
        sub = _jit_thin_cast_bf16(snaps, jnp.asarray(idx, jnp.int32))
    return np.asarray(sub).astype(np.float64), idx


def run_transient(
    K_np: Dict,
    M_np: Dict,
    mesh: StructuredMesh,
    bc: DirichletBC,
    b_source_np: np.ndarray,
    u0_np: np.ndarray,
    dt: float,
    num_steps: int,
    theta: float = 1.0,
    vdim: int = 1,
    config: Optional[SolverConfig] = None,
    mg_level_builder=None,
    C_np: Optional[Dict] = None,
    time_mod: Optional[Dict] = None,
    convection_scheme: str = "ab1",
) -> TransientResult:
    """``mg_level_builder(mesh_c) -> (K_c, M_c, bc_c)`` (optional) enables
    MG-PCG step solves: the implicit operator M + θΔtK is re-assembled per
    coarse level and each scan step runs a V-cycle-preconditioned CG.

    ``C_np`` (optional): a non-symmetric convection stencil applied
    EXPLICITLY (IMEX) — the implicit solve stays SPD, so CG/MG and the
    sharded scan work unchanged.  C's offsets must be a subset of K∪M's
    (true for same-mesh P1 assembly).  ``convection_scheme`` picks the
    explicit treatment:

    * ``"ab1"``: (M + θΔtK) u⁺ = (M − (1−θ)ΔtK − ΔtC) u + Δt b — C folds
      into the explicit-side operator, O(Δt) splitting.
    * ``"cnab2"``: Adams-Bashforth-2 extrapolation
      (M + θΔtK) u⁺ = (M − (1−θ)ΔtK) u − Δt(3/2 C u − 1/2 C u⁻) + Δt b —
      O(Δt²) overall with θ=1/2 (Crank-Nicolson/Adams-Bashforth, the
      standard IMEX pair).  The scan carries the previous state; the first
      step self-starts as AB1, and checkpoints persist the history so
      resumes stay bitwise.

    ``time_mod`` (optional): sinusoidal driving — extension beyond the
    reference's constant sources/BCs (fenics_mcp_server.py:304-318 rebuild
    a CONSTANT L every step).  Dict keys: ``omega`` [rad/s], ``phase``
    (default 0), ``source_amp`` (assembled load-vector amplitude b1:
    b(t) = b0 + sin(ωt+φ)·b1) and/or ``bc_amp_values`` (node-shaped
    Dirichlet amplitude: g(t) = g0 + sin(ωt+φ)·g_amp on constrained DOFs).
    Composes with the sharded scan path (shard_devices > 1)."""
    import time as _time

    cfg = config or get_config()
    t_setup = _time.perf_counter()
    prec = cfg.resolve_precision()
    d = mesh.dim
    n = int(np.prod(mesh.node_shape)) * vdim
    maxiter = cfg.resolved_maxiter(n)

    if convection_scheme not in ("ab1", "cnab2"):
        raise ValueError(f"unknown convection_scheme {convection_scheme!r}")
    cnab2 = bool(C_np) and convection_scheme == "cnab2"
    A_np = _combine(K_np, M_np, alpha=theta * dt, beta=1.0)
    B_np = _combine(K_np, M_np, alpha=-(1.0 - theta) * dt, beta=1.0)
    if C_np and not cnab2:
        B_np = _combine(C_np, B_np, alpha=-dt, beta=1.0)

    # Scaled, masked implicit operator (zero rhs — we only need the weights,
    # the per-step lift happens inside the scan with precomputed A g).
    sysm = prepare_system(A_np, mesh, bc, np.zeros(u0_np.shape), vdim)
    offsets, scaled, gvals = sysm.offsets, sysm.weights, sysm.gvals
    Ag_np = np_stencil_apply(A_np, gvals, d, vdim)
    free_np = np.asarray(bc.free_mask, dtype=np.float64)
    B_list = [np.asarray(B_np.get(o, np.zeros_like(scaled[i])), dtype=np.float64)
              for i, o in enumerate(offsets)]
    C_list = None
    if cnab2:
        C_list = [dt * np.asarray(C_np.get(o, np.zeros_like(B_list[i])),
                                  dtype=np.float64)
                  for i, o in enumerate(offsets)]

    # Sinusoidal-driving operands in numpy form (shared by the sharded and
    # single-device scans; b1 pre-scaled by dt, g1 restricted to
    # constrained DOFs with its matching lift A·g1).
    tmod_np = None
    if time_mod:
        b1_raw = time_mod.get("source_amp")
        g1_raw = time_mod.get("bc_amp_values")
        g1_np = Ag1_np = None
        if g1_raw is not None:
            g1_np = (1.0 - free_np) * np.asarray(g1_raw, np.float64)
            Ag1_np = np_stencil_apply(A_np, g1_np, d, vdim)
        tmod_np = {
            "b1": None if b1_raw is None else dt * np.asarray(b1_raw,
                                                              np.float64),
            "g1": g1_np, "Ag1": Ag1_np,
            "omega": float(time_mod["omega"]),
            "phase": float(time_mod.get("phase", 0.0)),
            "dt": float(dt), "theta": float(theta)}

    # Domain-decomposed stepping (SolverConfig.shard_devices): the whole
    # θ-scheme scan runs inside one shard_map — grid arrays sharded along
    # axis 0 with identity-row padding, halo-exchange applies, psum-CG step
    # solves (parallel.shard.ShardedThetaScan).
    nshard = cfg.resolved_shard_devices()
    if nshard > 1:
        from pde_solver.parallel.shard import ShardedThetaScan, device_mesh
        from pde_solver.utils.observability import get_logger
        sh_dtype = jnp.float32 if prec == "f32" else jnp.float64
        sh_tol = cfg.tol if prec == "f64" else cfg.transient_inner_tol
        get_logger().info("sharded transient scan: %d devices, %d steps",
                          nshard, int(num_steps))
        if cfg.transient_checkpoint_every > 0:
            get_logger().warning(
                "transient_checkpoint_every=%d is not supported on the "
                "sharded scan path (shard_devices=%d) — running without "
                "mid-solve checkpoints", cfg.transient_checkpoint_every,
                nshard)
        scan = ShardedThetaScan(sysm, B_list, free_np, Ag_np,
                                dt * np.asarray(b_source_np, np.float64),
                                u0_np.shape, d, vdim, device_mesh(nshard),
                                dtype=sh_dtype, inner_tol=sh_tol,
                                maxiter=maxiter, C_list=C_list,
                                tmod=tmod_np)
        setup_s = _time.perf_counter() - t_setup
        t_scan = _time.perf_counter()
        snaps, iters, res = scan.run(u0_np, int(num_steps))
        iters, res = int(iters), float(res)  # scalar pulls: scan complete
        scan_s = _time.perf_counter() - t_scan
        t_fetch = _time.perf_counter()
        values = np.concatenate([np.asarray(u0_np, np.float64)[None],
                                 np.asarray(snaps, np.float64)], axis=0)
        times = dt * np.arange(num_steps + 1, dtype=np.float64)
        return TransientResult(values=values, times=times,
                               total_cg_iterations=iters,
                               max_relative_residual=res,
                               setup_seconds=setup_s, scan_seconds=scan_s,
                               fetch_seconds=(_time.perf_counter()
                                              - t_fetch))

    state_dtype = jnp.float64 if prec in ("f64", "mixed") else jnp.float32
    A64 = tuple(jnp.asarray(W, dtype=jnp.float64) for W in scaled) \
        if prec in ("f64", "mixed") else None
    A32 = tuple(jnp.asarray(W, dtype=jnp.float32) for W in scaled) \
        if prec in ("f32", "mixed") else None
    B_w = tuple(jnp.asarray(W, dtype=state_dtype) for W in B_list)
    Cw = None if C_list is None else tuple(
        jnp.asarray(W, dtype=state_dtype) for W in C_list)

    inner_tol = cfg.tol if prec == "f64" else cfg.transient_inner_tol
    refine = cfg.transient_refine_rounds if prec == "mixed" else 0
    snap32 = cfg.snapshot_dtype == "f32" and prec != "f64"

    h_struct = level_arrays = None
    if (mg_level_builder is not None and cfg.use_multigrid
            and n >= cfg.resolved_transient_mg_threshold()):
        from pde_solver.ops import multigrid as mg

        def A_builder(mesh_c):
            K_c, M_c, bc_c = mg_level_builder(mesh_c)
            return _combine(K_c, M_c, alpha=theta * dt, beta=1.0), bc_c

        # mixed: the hierarchy serves the f32 corrections
        h = mg.build_hierarchy(mesh, sysm, A_builder, vdim=vdim,
                               dtype=jnp.float32 if prec == "mixed"
                               else state_dtype)
        if h is not None:
            h_struct, level_arrays = mg.hierarchy_struct(h)

    if sysm.scale_kind == "scalar":
        s_dev = jnp.asarray(sysm.s, dtype=state_dtype)
        Ct_dev = CinvT_dev = None
    else:
        s_dev = None
        Ct_dev = jnp.asarray(sysm.Ct, dtype=state_dtype)
        CinvT_dev = jnp.asarray(sysm.CinvT, dtype=state_dtype)

    # Stage every scan operand on device BEFORE the stepping clock starts,
    # so scan_seconds measures stepping, not uploads.
    scan_args = (
        offsets, A32, A64, B_w,
        jnp.asarray(free_np, dtype=state_dtype),
        jnp.asarray(gvals, dtype=state_dtype),
        s_dev, Ct_dev, CinvT_dev,
        jnp.asarray(dt * b_source_np, dtype=state_dtype),
        jnp.asarray(Ag_np, dtype=state_dtype),
        jnp.asarray(u0_np, dtype=state_dtype))
    tail = (maxiter, refine, d, vdim, prec, snap32, h_struct, level_arrays)

    tmod = None
    if tmod_np is not None:
        # amplitude lives on constrained DOFs only; the matching lift
        # A·g1 scales with the same sinusoid inside the scan (both built
        # in numpy above, shared with the sharded path)
        tmod = tuple(
            [None if tmod_np[k] is None else jnp.asarray(tmod_np[k],
                                                         dtype=state_dtype)
             for k in ("b1", "g1", "Ag1")]
            + [jnp.asarray(tmod_np[k], dtype=state_dtype)
               for k in ("omega", "phase", "dt", "theta")])
    # every staging upload — scan operands, operator weights, hierarchy
    # levels — finishes inside setup_seconds
    jax.block_until_ready((scan_args[1:], level_arrays, tmod, Cw))
    setup_s = _time.perf_counter() - t_setup
    t_scan = _time.perf_counter()

    # Snapshot thinning: the stacked [Nt][N] trajectory is the HBM hazard
    # for long transients at multi-M DOF (SURVEY §7 "hard parts").  When
    # the dense trajectory would exceed the budget, keep every k-th frame
    # (the plotters cap animations at ~30 frames regardless, matching
    # fenics_mcp_server.py:3042-3048); the final state is always kept.
    snap_bytes = n * (4 if (snap32 or prec != "f64") else 8)
    snap_every = 1
    if cfg.snapshot_max_frames > 0:
        snap_every = max(1, -(-int(num_steps) // cfg.snapshot_max_frames))
    elif num_steps * snap_bytes > cfg.snapshot_budget_bytes:
        snap_every = -(-(num_steps * snap_bytes) // cfg.snapshot_budget_bytes)

    if cfg.transient_checkpoint_every > 0:
        # Content key covers EVERYTHING that determines the trajectory:
        # both operators (A scaled + lift, B), BC data, initial state,
        # source, and the numerics config (precision/tolerance/refine) —
        # a checkpoint from a run with different boundary values or a
        # different precision mode must never be resumed (distinct key).
        # num_steps is deliberately excluded so a longer target continues
        # a shorter/killed run.
        import hashlib
        hsh = hashlib.blake2b(digest_size=12)
        hsh.update(repr((mesh.node_shape, vdim, float(dt), float(theta),
                         prec, float(inner_tol), int(refine), bool(snap32),
                         int(maxiter))).encode())
        for arr in ((u0_np, b_source_np, gvals, Ag_np, free_np)
                    + tuple(scaled) + tuple(B_list)):
            hsh.update(np.ascontiguousarray(np.asarray(arr, np.float64)))
        if time_mod:
            hsh.update(repr((float(time_mod["omega"]),
                             float(time_mod.get("phase", 0.0)))).encode())
            for key_m in ("source_amp", "bc_amp_values"):
                if time_mod.get(key_m) is not None:
                    hsh.update(np.ascontiguousarray(
                        np.asarray(time_mod[key_m], np.float64)))
        if cnab2:
            # AB1's C folds into B_list (hashed above); the CNAB2 history
            # scheme and its separate C operand must key distinctly.
            hsh.update(b"cnab2")
            for arr in C_list:
                hsh.update(np.ascontiguousarray(arr))
        return _run_transient_checkpointed(
            scan_args, tail, inner_tol, int(num_steps), cfg, dt, u0_np,
            state_dtype, setup_s, hsh.hexdigest(), snap_every, tmod, Cw)

    if snap_every <= 1:
        snaps, iters, res = _transient_scan(
            *scan_args, inner_tol, int(num_steps), *tail, tmod, None, Cw)
        iters, res = int(iters), float(res)  # scalar pulls: scan complete
        scan_s = _time.perf_counter() - t_scan
        t_fetch = _time.perf_counter()
        traj, kept = _fetch_trajectory(snaps, cfg)  # bulk pull
        values = np.concatenate(
            [np.asarray(u0_np, dtype=np.float64)[None], traj], axis=0)
        if kept is None:
            times = dt * np.arange(num_steps + 1, dtype=np.float64)
        else:
            times = dt * np.asarray([0] + [i + 1 for i in kept], np.float64)
    else:
        main = (int(num_steps) // snap_every) * snap_every
        snaps, u_f, iters, res = _transient_scan_thinned(
            *scan_args[:-1], scan_args[-1], inner_tol, main, *tail,
            snap_every, tmod, None, Cw)
        u_prev_f = None
        if Cw is not None:
            u_f, u_prev_f = u_f
        t_main = [dt * snap_every * (j + 1)
                  for j in range(main // snap_every)]
        rem = int(num_steps) - main
        snaps2 = None
        if rem > 0:
            snaps2, iters2, res2 = _transient_scan(
                scan_args[0], *scan_args[1:-1], u_f.astype(state_dtype),
                inner_tol, rem, *tail, tmod,
                jnp.asarray(main, jnp.int32), Cw, u_prev_f)
            iters = iters + iters2
            res = jnp.maximum(res, res2)
        iters, res = int(iters), float(res)  # scalar pulls: scans complete
        scan_s = _time.perf_counter() - t_scan
        t_fetch = _time.perf_counter()
        traj, kept = _fetch_trajectory(snaps, cfg)  # bulk pull
        if kept is not None:
            t_main = [t_main[j] for j in kept]
        frames = [np.asarray(u0_np, dtype=np.float64)[None], traj]
        t_list = [0.0] + t_main
        if snaps2 is not None:
            frames.append(np.asarray(snaps2[-1:], dtype=np.float64))
            t_list.append(dt * num_steps)
        values = np.concatenate(frames, axis=0)
        times = np.asarray(t_list, dtype=np.float64)
    return TransientResult(values=values, times=times,
                           total_cg_iterations=iters,
                           max_relative_residual=res,
                           setup_seconds=setup_s, scan_seconds=scan_s,
                           fetch_seconds=_time.perf_counter() - t_fetch)


# ----------------------------------------------------------------------
# Checkpoint/resume for long transients (SURVEY §5 checkpoint/resume row)
# ----------------------------------------------------------------------

_CKPT_TEST_ABORT = 0  # tests: raise after N chunk checkpoints (0 = off)


def _run_transient_checkpointed(scan_args, tail, inner_tol, num_steps, cfg,
                                dt, u0_np, state_dtype, setup_s, key: str,
                                snap_every: int = 1,
                                tmod=None, Cw=None) -> TransientResult:
    """Host-chunked scan with atomic carry+trajectory checkpoints.

    Every ``transient_checkpoint_every`` steps the scan carry and the
    accumulated snapshots persist to ``checkpoint_dir`` (tmp+rename).  A
    re-run of the same problem (content-keyed on the full operator/BC/
    state/config content — NOT on num_steps, so a longer target continues
    a shorter/killed run) resumes from the last completed chunk; on
    completion the checkpoint is removed.  Chunking does not change the
    per-step arithmetic — the trajectory is bitwise what the equivalent
    thinned scan produces.

    Snapshot thinning applies INSIDE the chunks (``snap_every``, computed
    by run_transient from the same budget as the plain path), so both the
    host trajectory and the rewritten checkpoint stay bounded by the
    snapshot budget instead of growing O(num_steps) — each stored frame
    carries its global step index so resumes with a different thinning
    cadence (num_steps changed → snap_every changed) stay consistent.
    """
    import os
    import tempfile
    import time as _time

    from pde_solver.utils.observability import get_logger

    t_scan = _time.perf_counter()
    snap_every = max(1, int(snap_every))
    # chunk length: the checkpoint cadence rounded up to a whole number of
    # snapshot intervals, so every chunk boundary is a stored frame.
    every = max(int(cfg.transient_checkpoint_every), snap_every)
    every = -(-every // snap_every) * snap_every
    path = os.path.join(cfg.checkpoint_dir, f"transient-{key}.npz")
    frames = [np.asarray(u0_np, dtype=np.float64)[None]]
    snap_steps = []          # global step index of each stored frame (no u0)
    start = 0
    iters_acc = 0
    res_acc = 0.0
    u_cur = scan_args[-1]
    u_prev = None   # CNAB2 history (Cw paths): None → AB1 bootstrap from u0
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                snaps_prev = z["snaps"]
                steps_prev = [int(t) for t in z["snap_steps"]]
                start = int(z["step"])
                iters_acc = int(z["iters"])
                res_acc = float(z["res"])
                u_cur = jnp.asarray(z["carry"], dtype=state_dtype)
                if "u_prev" in z.files:
                    u_prev = jnp.asarray(z["u_prev"], dtype=state_dtype)
            if start > num_steps:
                # The checkpoint is AHEAD of this (shorter) request: the
                # stored carry can't produce u(num_steps), so recompute
                # from scratch — resuming would return a trajectory longer
                # than the times axis (inconsistent result shapes).
                get_logger().warning(
                    "transient checkpoint at step %d exceeds requested "
                    "num_steps=%d — recomputing from step 0", start,
                    num_steps)
                start, iters_acc, res_acc = 0, 0, 0.0
                u_cur = scan_args[-1]
                u_prev = None
            else:
                frames.append(snaps_prev.astype(np.float64))
                snap_steps.extend(steps_prev)
                get_logger().info("transient resume: step %d/%d from %s",
                                  start, num_steps, path)
        except Exception:
            frames = [np.asarray(u0_np, dtype=np.float64)[None]]
            snap_steps = []
            start, iters_acc, res_acc = 0, 0, 0.0
            u_cur = scan_args[-1]
            u_prev = None
    chunks_done = 0
    fetch_acc = 0.0
    main = start + ((num_steps - start) // snap_every) * snap_every
    while start < main:
        n = min(every, main - start)
        snaps, u_f, k, res = _transient_scan_thinned(
            *scan_args[:-1], u_cur, inner_tol, n, *tail, snap_every, tmod,
            jnp.asarray(start, jnp.int32), Cw, u_prev)
        if Cw is not None:
            u_f, u_prev_f = u_f
            u_prev = u_prev_f.astype(state_dtype)
        iters_acc += int(k)  # scalar pull: chunk scan complete
        res_acc = max(res_acc, float(res))
        t_f = _time.perf_counter()
        frames.append(np.asarray(snaps, dtype=np.float64))  # bulk pull
        fetch_acc += _time.perf_counter() - t_f
        snap_steps.extend(start + snap_every * (j + 1)
                          for j in range(n // snap_every))
        u_cur = u_f.astype(state_dtype)
        start += n
        # atomic checkpoint: carry + the (thinned, budget-bounded) frames
        # (+ the AB2 history on CNAB2 paths, so resumes stay bitwise)
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=cfg.checkpoint_dir, suffix=".tmp.npz")
        os.close(fd)
        all_snaps = np.concatenate([f for f in frames[1:]], axis=0)
        extra_npz = {} if u_prev is None else {"u_prev": np.asarray(u_prev)}
        np.savez(tmp, snaps=all_snaps.astype(
            np.float32 if tail[5] else np.float64),
            snap_steps=np.asarray(snap_steps, np.int64),
            carry=np.asarray(u_cur), step=start, iters=iters_acc,
            res=res_acc, **extra_npz)
        os.replace(tmp, path)
        chunks_done += 1
        if _CKPT_TEST_ABORT and chunks_done >= _CKPT_TEST_ABORT \
                and start < num_steps:
            raise RuntimeError("checkpoint test abort")
    rem = num_steps - start
    if rem > 0:
        # final sub-interval (num_steps not divisible by snap_every): step
        # to the end and keep only the final state, like the plain path.
        snaps2, k2, res2 = _transient_scan(
            *scan_args[:-1], u_cur, inner_tol, rem, *tail, tmod,
            jnp.asarray(start, jnp.int32), Cw, u_prev)
        iters_acc += int(k2)  # scalar pull: scan complete
        res_acc = max(res_acc, float(res2))
        t_f = _time.perf_counter()
        frames.append(np.asarray(snaps2[-1:], dtype=np.float64))
        fetch_acc += _time.perf_counter() - t_f
        snap_steps.append(num_steps)
    try:
        os.remove(path)  # run complete — the artifact model takes over
    except OSError:
        pass
    values = np.concatenate(frames, axis=0)
    times = dt * np.asarray([0] + snap_steps, dtype=np.float64)
    return TransientResult(values=values, times=times,
                           total_cg_iterations=iters_acc,
                           max_relative_residual=res_acc,
                           setup_seconds=setup_s,
                           scan_seconds=(_time.perf_counter() - t_scan
                                         - fetch_acc),
                           fetch_seconds=fetch_acc)


# ----------------------------------------------------------------------
# Newmark-β second-order dynamics (elastodynamics):  M ü + K u = f
# ----------------------------------------------------------------------
#
# New capability beyond the reference (its elasticity is static only,
# fenics_mcp_server.py:1470-1892).  Acceleration form, one jitted scan:
#
#   ũ       = uₙ + Δt vₙ + Δt² (½ − β) aₙ            (predictor)
#   A_eff a = free ⊙ (f − K ũ),  A_eff = M + β Δt² K  (CG on scaled system)
#   uₙ₊₁   = ũ + β Δt² aₙ₊₁
#   vₙ₊₁   = vₙ + Δt ((1−γ) aₙ + γ aₙ₊₁)
#
# β=¼, γ=½ (average acceleration) is unconditionally stable and exactly
# energy-conserving for f=0 in exact arithmetic — the test suite checks the
# discrete energy ½ vᵀMv + ½ uᵀKu drift.  Dirichlet nodes carry u=g fixed,
# v=a=0: A_eff's masked rows are identity with zero RHS there.

def _run_newmark_checkpointed(pre, post, tail, carry0, num_steps, cfg, dt,
                              u0_np, v0_np, state_dtype, key: str
                              ) -> "NewmarkResult":
    """Host-chunked Newmark scan with atomic (u, v, a)-carry checkpoints.

    Mirrors :func:`_run_transient_checkpointed`: every
    ``transient_checkpoint_every`` steps the full-precision scan carry and
    the accumulated displacement/velocity frames persist to
    ``checkpoint_dir`` (tmp+rename); a re-run of the same content-keyed
    problem resumes from the last completed chunk; the artifact is removed
    on completion.  The acceleration is carried explicitly, so chunking is
    bitwise identical to the single uninterrupted scan."""
    import os
    import tempfile

    from pde_solver.utils.observability import get_logger

    every = max(1, int(cfg.transient_checkpoint_every))
    path = os.path.join(cfg.checkpoint_dir, f"newmark-{key}.npz")
    u_frames = [np.asarray(u0_np, np.float64)[None]]
    v_frames = [np.asarray(v0_np, np.float64)[None]]
    start, iters_acc, res_acc = 0, 0, 0.0
    carry = carry0
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                if int(z["step"]) > num_steps:
                    get_logger().warning(
                        "newmark checkpoint at step %d exceeds requested "
                        "num_steps=%d — recomputing from step 0",
                        int(z["step"]), num_steps)
                else:
                    u_frames.append(z["us"].astype(np.float64))
                    v_frames.append(z["vs"].astype(np.float64))
                    start = int(z["step"])
                    iters_acc = int(z["iters"])
                    res_acc = float(z["res"])
                    carry = tuple(jnp.asarray(z[k], state_dtype)
                                  for k in ("u", "v", "a"))
                    get_logger().info("newmark resume: step %d/%d from %s",
                                      start, num_steps, path)
        except Exception:
            u_frames = [np.asarray(u0_np, np.float64)[None]]
            v_frames = [np.asarray(v0_np, np.float64)[None]]
            start, iters_acc, res_acc = 0, 0, 0.0
            carry = carry0
    chunks_done = 0
    while start < num_steps:
        n_chunk = min(every, num_steps - start)
        us, vs, carry_f, k, r = _newmark_scan(*pre, *carry, *post,
                                              int(n_chunk), *tail)
        iters_acc += int(k)  # scalar pull: chunk scan complete
        res_acc = max(res_acc, float(r))
        u_frames.append(np.asarray(us, np.float64))
        v_frames.append(np.asarray(vs, np.float64))
        carry = tuple(c.astype(state_dtype) for c in carry_f)
        start += n_chunk
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=cfg.checkpoint_dir, suffix=".tmp.npz")
        os.close(fd)
        snap_t = np.float32 if tail[3] else np.float64
        np.savez(tmp,
                 us=np.concatenate(u_frames[1:], axis=0).astype(snap_t),
                 vs=np.concatenate(v_frames[1:], axis=0).astype(snap_t),
                 u=np.asarray(carry[0]), v=np.asarray(carry[1]),
                 a=np.asarray(carry[2]), step=start, iters=iters_acc,
                 res=res_acc)
        os.replace(tmp, path)
        chunks_done += 1
        if _CKPT_TEST_ABORT and chunks_done >= _CKPT_TEST_ABORT \
                and start < num_steps:
            raise RuntimeError("checkpoint test abort")
    try:
        os.remove(path)  # run complete — the artifact model takes over
    except OSError:
        pass
    times = dt * np.arange(num_steps + 1, dtype=np.float64)
    return NewmarkResult(values=np.concatenate(u_frames, axis=0),
                         velocities=np.concatenate(v_frames, axis=0),
                         times=times, total_cg_iterations=iters_acc,
                         max_relative_residual=res_acc)


class NewmarkResult(NamedTuple):
    values: np.ndarray       # [num_steps+1, *node_shape, v] displacements
    velocities: np.ndarray   # [num_steps+1, *node_shape, v]
    times: np.ndarray
    total_cg_iterations: int
    max_relative_residual: float


@partial(jax.jit, static_argnames=("offsets", "num_steps", "maxiter",
                                   "grid_dim", "vdim", "snap32", "h_struct"))
def _newmark_scan(offsets, A_w, K_w, free, s, Ct, CinvT, f_ext, u0, v0, a0,
                  dt, beta, gamma, inner_tol, num_steps, maxiter, grid_dim,
                  vdim, snap32, h_struct=None, level_arrays=None):
    dtype = u0.dtype
    snap_dtype = jnp.float32 if snap32 else dtype
    to_hat_b, to_hat_x, from_hat_x = _make_scale_ops(s, Ct, CinvT)

    if h_struct is not None:
        from pde_solver.ops import multigrid as mg
        hh = mg.hierarchy_from_arrays(h_struct, level_arrays)

    def K(x):
        return _stencil_apply(offsets, K_w, x, grid_dim, vdim)

    c1 = dt * dt * (0.5 - beta)
    c2 = beta * dt * dt

    def step(carry, _):
        u, v, a, iters_acc, res_acc = carry
        u_pred = u + dt * v + c1 * a
        bt = free * (f_ext - K(u_pred))
        if h_struct is not None:
            from pde_solver.ops import multigrid as mg
            xh, k, relres = mg.mg_pcg(hh, to_hat_b(bt), to_hat_x(a),
                                      inner_tol, maxiter, resync_every=0)
        else:
            xh, k, relres = _cg_unit_diag(offsets, A_w, to_hat_b(bt),
                                          to_hat_x(a), inner_tol, maxiter,
                                          grid_dim, vdim)
        a_new = free * from_hat_x(xh)
        u_new = u_pred + c2 * a_new
        v_new = v + dt * ((1.0 - gamma) * a + gamma * a_new)
        return ((u_new, v_new, a_new, iters_acc + k,
                 jnp.maximum(res_acc, relres.astype(dtype))),
                (u_new.astype(snap_dtype), v_new.astype(snap_dtype)))

    carry0 = (u0, v0, a0, jnp.asarray(0, jnp.int32), jnp.asarray(0.0, dtype))
    (u_f, v_f, a_f, iters, res), (us, vs) = jax.lax.scan(
        step, carry0, None, length=num_steps)
    # the full-precision final carry enables bitwise chunked resumes (the
    # snapshots may be thinned to f32; the carry never is)
    return us, vs, (u_f, v_f, a_f), iters, res


def run_newmark(
    K_np: Dict,
    M_np: Dict,
    mesh: StructuredMesh,
    bc: DirichletBC,
    f_np: np.ndarray,
    u0_np: np.ndarray,
    v0_np: np.ndarray,
    dt: float,
    num_steps: int,
    beta: float = 0.25,
    gamma: float = 0.5,
    vdim: int = 1,
    config: Optional[SolverConfig] = None,
    mg_level_builder=None,
) -> NewmarkResult:
    """Implicit Newmark-β time integration of M ü + K u = f.

    ``K_np``/``M_np`` are (block) stencils; ``f_np`` a constant external
    load; ``u0_np`` must satisfy the Dirichlet values (they stay pinned).
    ``mg_level_builder(mesh_c) -> (K_c, M_c, bc_c)`` (optional) enables
    MG-PCG step solves on A_eff = M + βΔt²K above
    ``transient_mg_threshold`` DOF."""
    cfg = config or get_config()
    prec = cfg.resolve_precision()
    if prec == "mixed":
        prec = "f32"   # no f64 inside device scans (see run_transient)
    d = mesh.dim
    n = int(np.prod(mesh.node_shape)) * vdim
    maxiter = cfg.resolved_maxiter(n)

    A_np = _combine(K_np, M_np, alpha=beta * dt * dt, beta=1.0)
    # Acceleration BC values are zero ⇒ zero-valued mask with u's sparsity.
    bc0 = DirichletBC(np.asarray(bc.free_mask, np.float64),
                      np.zeros_like(np.asarray(bc.values, np.float64)))
    sysm = prepare_system(A_np, mesh, bc0, np.zeros(u0_np.shape), vdim)
    offsets = sysm.offsets

    state_dtype = jnp.float64 if prec == "f64" else jnp.float32
    A_w = tuple(jnp.asarray(W, dtype=state_dtype) for W in sysm.weights)
    K_list = [np.asarray(K_np.get(o, np.zeros(mesh.node_shape
                                              + ((vdim, vdim) if vdim > 1
                                                 else ()))), np.float64)
              for o in offsets]
    K_w = tuple(jnp.asarray(W, dtype=state_dtype) for W in K_list)

    free_np = np.asarray(bc.free_mask, dtype=np.float64)
    # Consistent initial acceleration: M a0 = free ⊙ (f − K u0)
    sys_m = prepare_system(M_np, mesh, bc0, free_np * (
        np.asarray(f_np, np.float64)
        - np_stencil_apply(K_np, np.asarray(u0_np, np.float64), d, vdim)),
        vdim)
    M_w = tuple(jnp.asarray(W, dtype=state_dtype) for W in sys_m.weights)
    xh0, _, _ = _cg_unit_diag(
        offsets, M_w, jnp.asarray(sys_m.b_hat, state_dtype),
        jnp.zeros(u0_np.shape, state_dtype),
        cfg.transient_inner_tol if prec != "f64" else cfg.tol,
        maxiter, d, vdim)
    a0 = jnp.asarray(free_np, state_dtype) * jnp.asarray(
        sys_m.from_hat_x(np.asarray(xh0, np.float64)), state_dtype)

    inner_tol = cfg.tol if prec == "f64" else cfg.transient_inner_tol

    # Domain-decomposed Newmark stepping (SolverConfig.shard_devices): the
    # whole scan runs inside one shard_map, same machinery as run_transient's
    # ShardedThetaScan (axis-0 decomposition, identity-row padding, halo
    # applies, psum-CG step solves).
    nshard = cfg.resolved_shard_devices()
    if nshard > 1:
        from pde_solver.parallel.shard import (ShardedNewmarkScan,
                                                   device_mesh)
        from pde_solver.utils.observability import get_logger
        if cfg.transient_checkpoint_every > 0:
            get_logger().warning(
                "transient_checkpoint_every=%d is not supported on the "
                "sharded Newmark path — running without mid-solve "
                "checkpoints", cfg.transient_checkpoint_every)
        get_logger().info("sharded Newmark scan: %d devices, %d steps",
                          nshard, int(num_steps))
        scan = ShardedNewmarkScan(
            sysm, K_list, free_np, np.asarray(f_np, np.float64),
            d, vdim, device_mesh(nshard), dt, beta, gamma,
            dtype=state_dtype, inner_tol=inner_tol, maxiter=maxiter)
        us, vs, iters, res = scan.run(np.asarray(u0_np, np.float64),
                                      np.asarray(v0_np, np.float64),
                                      np.asarray(a0, np.float64),
                                      int(num_steps))
        values = np.concatenate([np.asarray(u0_np, np.float64)[None],
                                 np.asarray(us, np.float64)], axis=0)
        vels = np.concatenate([np.asarray(v0_np, np.float64)[None],
                               np.asarray(vs, np.float64)], axis=0)
        times = dt * np.arange(num_steps + 1, dtype=np.float64)
        return NewmarkResult(values=values, velocities=vels, times=times,
                             total_cg_iterations=iters,
                             max_relative_residual=res)

    if sysm.scale_kind == "scalar":
        s_dev = jnp.asarray(sysm.s, state_dtype)
        Ct_dev = CinvT_dev = None
    else:
        s_dev = None
        Ct_dev = jnp.asarray(sysm.Ct, state_dtype)
        CinvT_dev = jnp.asarray(sysm.CinvT, state_dtype)

    snap32 = cfg.snapshot_dtype == "f32" and prec != "f64"

    h_struct = level_arrays = None
    if (mg_level_builder is not None and cfg.use_multigrid
            and n >= cfg.resolved_transient_mg_threshold()):
        from pde_solver.ops import multigrid as mg

        def A_builder(mesh_c):
            K_c, M_c, bc_c = mg_level_builder(mesh_c)
            return _combine(K_c, M_c, alpha=beta * dt * dt, beta=1.0), bc_c

        h = mg.build_hierarchy(mesh, sysm, A_builder, vdim=vdim,
                               dtype=state_dtype)
        if h is not None:
            h_struct, level_arrays = mg.hierarchy_struct(h)

    pre = (offsets, A_w, K_w, jnp.asarray(free_np, state_dtype),
           s_dev, Ct_dev, CinvT_dev, jnp.asarray(f_np, state_dtype))
    post = (float(dt), float(beta), float(gamma), inner_tol)
    tail = (maxiter, d, vdim, snap32, h_struct, level_arrays)
    carry0 = (jnp.asarray(u0_np, state_dtype),
              jnp.asarray(v0_np, state_dtype), a0)

    if cfg.transient_checkpoint_every > 0:
        # Mid-run checkpoint/resume, mirroring _run_transient_checkpointed:
        # the content key covers everything that determines the trajectory
        # (operators, BC data, state, forcing, numerics) but NOT num_steps,
        # so a longer target continues a shorter/killed run.
        import hashlib
        hsh = hashlib.blake2b(digest_size=12)
        hsh.update(repr((mesh.node_shape, vdim, float(dt), float(beta),
                         float(gamma), prec, float(inner_tol), int(maxiter),
                         bool(snap32))).encode())
        for arr in ((u0_np, v0_np, f_np, free_np,
                     np.asarray(bc.values, np.float64))
                    + tuple(sysm.weights) + tuple(K_list)):
            hsh.update(np.ascontiguousarray(np.asarray(arr, np.float64)))
        return _run_newmark_checkpointed(
            pre, post, tail, carry0, int(num_steps), cfg, dt,
            u0_np, v0_np, state_dtype, hsh.hexdigest())

    us, vs, _, iters, res = _newmark_scan(
        *pre, *carry0, *post, int(num_steps), *tail)

    values = np.concatenate([np.asarray(u0_np, np.float64)[None],
                             np.asarray(us, np.float64)], axis=0)
    vels = np.concatenate([np.asarray(v0_np, np.float64)[None],
                           np.asarray(vs, np.float64)], axis=0)
    times = dt * np.arange(num_steps + 1, dtype=np.float64)
    return NewmarkResult(values=values, velocities=vels, times=times,
                         total_cg_iterations=int(iters),
                         max_relative_residual=float(res))
