"""Linear-solve facade: stencil system + BC → solution, per precision policy.

One entry point used by every model (heat, elasticity, projections).

System preparation (host, numpy, once per solve):

* **Dirichlet masking is baked into the weights** — constrained rows/columns
  are zeroed and the diagonal gets 1 there, so the device operator is a pure
  stencil SpMV (no mask multiplies per iteration, SPD preserved);
* **symmetric Jacobi scaling** is baked in too: scalar D^{-1/2} A D^{-1/2}
  for scalar fields, block-Cholesky C^{-1} A C^{-T} (3×3 node blocks) for
  elasticity.  The scaled system has an identity (block-)diagonal, which
  (a) is Jacobi / block-Jacobi preconditioning and (b) keeps float32
  arithmetic well-ranged even for E≈2e11 Pa;
* the RHS lift b̃ = free ⊙ (b − A g) + g happens on host in float64.

Solve modes:

* "f64" — one jitted CG program in float64 (CPU / tests).
* "mixed" (accelerator default, see ``config.backend_policy``) — float32 CG
  inner solves + float64 residual refinement, decomposed into small
  separately-jitted programs driven by a host loop; only scalars and f32
  correction vectors cross the host boundary per round.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pde_solver.config import SolverConfig, get_config
from pde_solver.mesh import StructuredMesh
from pde_solver.ops.bc import DirichletBC
from pde_solver.ops.cg import SolveStats
from pde_solver.ops.stencil import block_matvec

Offset = Tuple[int, ...]


# ----------------------------------------------------------------------
# Host-side system preparation (numpy, float64)
# ----------------------------------------------------------------------

def _np_shift(arr: np.ndarray, off: Offset, grid_dim: int) -> np.ndarray:
    """arr evaluated at n+off with zero padding (host helper)."""
    pad = [(1, 1)] * grid_dim + [(0, 0)] * (arr.ndim - grid_dim)
    ap = np.pad(arr, pad)
    sl = tuple(slice(1 + o, 1 + o + s) for o, s in zip(off, arr.shape[:grid_dim]))
    return ap[sl + (Ellipsis,)]


def np_stencil_apply(stencil: Dict[Offset, np.ndarray], x: np.ndarray,
                     grid_dim: int, vdim: int = 1) -> np.ndarray:
    y = np.zeros_like(x)
    for off, W in stencil.items():
        xs = _np_shift(x, off, grid_dim)
        if vdim == 1:
            y += W * xs
        else:
            y += np.einsum("...ij,...j->...i", W, xs)
    return y


class ScaledSystem(NamedTuple):
    """Masked + diagonally-scaled stencil system (host arrays, float64)."""

    offsets: Tuple[Offset, ...]
    weights: list                  # scaled Ŵ_o, aligned with offsets
    b_hat: np.ndarray              # scaled, lifted RHS
    gvals: np.ndarray              # Dirichlet values (0 on free DOFs)
    free: np.ndarray               # 1.0 on free DOFs, 0.0 on constrained
    scale_kind: str                # "scalar" | "block"
    s: Optional[np.ndarray]        # scalar: 1/sqrt(diag)
    Ct: Optional[np.ndarray]       # block: C^T  (x̂ = C^T x)
    CinvT: Optional[np.ndarray]    # block: C^{-T} (x = C^{-T} x̂)
    ckey: Optional[tuple] = None   # content key (set for systems above
                                   # _PREP_CACHE_MIN_DOF) — reused by the
                                   # MG hierarchy disk cache so the scaled
                                   # weights aren't hashed a second time

    def from_hat_x(self, x_hat: np.ndarray) -> np.ndarray:
        if self.scale_kind == "scalar":
            return self.s * x_hat
        return np.einsum("...ij,...j->...i", self.CinvT, x_hat)

    def to_hat_x(self, x: np.ndarray) -> np.ndarray:
        if self.scale_kind == "scalar":
            return x / self.s
        return np.einsum("...ij,...j->...i", self.Ct, x)


# Operator-part cache for prepare_system: the masked+scaled weights and
# scale factors depend on (stencil, free-mask PATTERN) only — not on the
# RHS or the BC *values* — and cost ~25 s of 1-core numpy at 2M-DOF
# elasticity.  Content-keyed (blake2b over the weight + mask bytes, ~2 s
# at 2M, ~40 ms at 132k); only systems above _PREP_CACHE_MIN_DOF cache (below
# prepare is fast and per-level coarse systems would churn the LRU).
# Entries also persist to disk (utils.diskcache) so a fresh process — e.g.
# every driver bench run — skips the host prep entirely.
_PREP_CACHE: Dict = {}
_PREP_CACHE_MAX = 2
_PREP_CACHE_MIN_DOF = 100_000


def _prep_cache_key(stencil: Dict, free: np.ndarray, node_shape, vdim: int):
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for off in sorted(stencil.keys()):
        h.update(np.ascontiguousarray(np.asarray(stencil[off], np.float64)))
    h.update(np.ascontiguousarray(free))
    # "v2": the cache core stores contiguous C/Cinv (not transposed views) —
    # einsum rounding depends on memory layout, so every path must hand the
    # SAME layout to the b̂ computation for bitwise-reproducible results
    return (tuple(node_shape), vdim, tuple(sorted(stencil.keys())),
            h.hexdigest(), "v2")


def _freeze(core):
    """Mark cached arrays read-only — the cache hands the SAME objects to
    every ScaledSystem that hits it; an in-place mutation by any future
    consumer would silently corrupt later solves."""
    scaled, s, C, Cinv = core
    for a in scaled:
        a.setflags(write=False)
    for a in (s, C, Cinv):
        if a is not None:
            a.setflags(write=False)
    return core


def _prep_core_get(key, n_off: int, vdim: int):
    """Memory-first, then disk.  Returns (scaled, s, C, Cinv) — C/Cinv
    contiguous, exactly as the fresh compute produces them — or None."""
    core = _PREP_CACHE.pop(key, None)
    if core is not None:
        _PREP_CACHE[key] = core  # LRU refresh
        return core
    from pde_solver.utils import diskcache
    ent = diskcache.load("prep", key)
    if ent is None:
        return None
    try:
        scaled = [ent[f"w{i}"] for i in range(n_off)]
        if vdim == 1:
            core = (scaled, ent["s"], None, None)
        else:
            core = (scaled, None, ent["C"], ent["Cinv"])
    except KeyError:
        return None
    _prep_core_put(key, _freeze(core), disk=False)
    return core


def _prep_core_put(key, core, disk: bool = True):
    _PREP_CACHE[key] = _freeze(core)
    while len(_PREP_CACHE) > _PREP_CACHE_MAX:
        _PREP_CACHE.pop(next(iter(_PREP_CACHE)))
    if disk:
        from pde_solver.utils import diskcache
        scaled, s, C, Cinv = core
        arrays = {f"w{i}": np.asarray(W) for i, W in enumerate(scaled)}
        for name, a in (("s", s), ("C", C), ("Cinv", Cinv)):
            if a is not None:
                arrays[name] = np.asarray(a)
        diskcache.store("prep", key, arrays)


def prepare_system(stencil: Dict[Offset, np.ndarray], mesh: StructuredMesh,
                   bc: DirichletBC, rhs: np.ndarray, vdim: int = 1
                   ) -> ScaledSystem:
    """Bake masking + (block-)diagonal scaling into the weights."""
    d = mesh.dim
    free = np.asarray(bc.free_mask, dtype=np.float64)
    gvals = np.asarray(bc.values, dtype=np.float64) * (1.0 - free)

    # RHS lift with the *unmasked* operator (host, one pass; skipped when
    # all Dirichlet values are zero — A·0 = 0)
    if np.any(gvals):
        Ag = np_stencil_apply(stencil, gvals, d, vdim)
        b_t = free * (np.asarray(rhs, dtype=np.float64) - Ag) + gvals
    else:
        b_t = free * np.asarray(rhs, dtype=np.float64)

    zero = tuple(0 for _ in range(d))
    offsets = tuple(sorted(stencil.keys()))

    n = int(np.prod(mesh.node_shape)) * vdim
    key = None
    if n >= _PREP_CACHE_MIN_DOF:
        key = _prep_cache_key(stencil, free, mesh.node_shape, vdim)
        core = _prep_core_get(key, len(offsets), vdim)
        if core is not None:
            scaled, s, C, Cinv = core
            if vdim == 1:
                return ScaledSystem(offsets, scaled, s * b_t, gvals, free,
                                    "scalar", s, None, None, ckey=key)
            b_hat = np.einsum("...ab,...b->...a", Cinv, b_t)
            return ScaledSystem(offsets, scaled, b_hat, gvals, free,
                                "block", None, np.swapaxes(C, -1, -2),
                                np.swapaxes(Cinv, -1, -2), ckey=key)

    if vdim == 1:
        diag = stencil[zero] * free + (1.0 - free)
        diag = np.where(diag <= 0, 1.0, diag)
        s = 1.0 / np.sqrt(diag)
        scaled = []
        for off in offsets:
            W = np.array(stencil[off], dtype=np.float64)
            free_o = _np_shift(free, off, d)
            s_o = _np_shift(s, off, d)
            W = W * (free * free_o) * (s * s_o)
            if off == zero:
                W = W + (1.0 - free)
            scaled.append(W)
        if key is not None:
            _prep_core_put(key, (scaled, s, None, None))
        return ScaledSystem(offsets, scaled, s * b_t, gvals, free, "scalar", s,
                            None, None, ckey=key)

    # vdim > 1: block-Cholesky scaling (block-Jacobi preconditioning baked in)
    eye = np.eye(vdim)
    masked = {}
    for off in offsets:
        W = np.array(stencil[off], dtype=np.float64)
        free_o = _np_shift(free, off, d)
        W = W * (free[..., :, None] * free_o[..., None, :])
        if off == zero:
            W = W + (1.0 - free)[..., :, None] * eye
        masked[off] = W
    D = masked[zero]                       # [..., v, v] SPD blocks
    C = np.linalg.cholesky(D)
    Cinv = np.linalg.inv(C)
    scaled = []
    for off in offsets:
        Cinv_o = _np_shift(Cinv, off, d)
        # Ŵ_o[n] = C^{-1}[n] W_o[n] C^{-T}[n+o]
        W = np.einsum("...ab,...bc,...dc->...ad", Cinv, masked[off], Cinv_o)
        scaled.append(W)
    b_hat = np.einsum("...ab,...b->...a", Cinv, b_t)
    Ct = np.swapaxes(C, -1, -2)
    CinvT = np.swapaxes(Cinv, -1, -2)
    if key is not None:
        _prep_core_put(key, (scaled, None, C, Cinv))
    return ScaledSystem(offsets, scaled, b_hat, gvals, free, "block", None,
                        Ct, CinvT, ckey=key)


# ----------------------------------------------------------------------
# Device programs (each small — compile stays cheap; see module docstring)
# ----------------------------------------------------------------------

class CSOp(NamedTuple):
    """Constant-interior stencil operator: tiny constant weights + boundary
    slab recompute.

    On a translation-invariant structured mesh every interior node assembles
    the identical element neighbourhood, and the baked-in diagonal scaling is
    likewise constant away from the boundary — so the full per-node weight
    arrays (27 offsets × v² components × N nodes ≈ 660 MB at 2M DOF) carry
    ~1 scalar of information each.  This representation stores the constant
    interior stencil (`wc`, a few hundred scalars) plus exact dense weights
    on the six thickness-2 boundary face slabs only (~14 % of N).

    Apply = constant-stencil pass over the whole grid, then overwrite the six
    face slabs with the exact dense computation.  Rows whose weights differ
    from the interior constant anywhere deeper than the two outermost node
    layers (spatially-varying coefficients, interior Dirichlet shells) fail
    the builder's exact-equality check and fall back to the dense operator.

    It is not wired into the solve paths: the slab overwrites add many
    small HLO ops and compile time, and whether the smaller weight stream
    wins on the GPU is not measured yet.
    """

    wc: jnp.ndarray                            # [n_off] | [n_off, v, v]
    slabs: Tuple[jnp.ndarray, ...]             # 2·grid_dim stacked face arrays


# Dirichlet column-masking perturbs weights one node INSIDE the boundary
# too (couplings into constrained nodes are zeroed), so the recomputed
# boundary shell is two nodes thick.
_CS_SHELL = 2


def make_cs_op(offsets: Tuple[Offset, ...], weights_np, grid_dim: int,
               vdim: int, dtype) -> Optional[CSOp]:
    """Build a CSOp from per-node weight arrays, or None if the stencil is
    not exactly translation-invariant on the strict interior."""
    t = _CS_SHELL
    W0 = np.asarray(weights_np[0])
    node_shape = W0.shape[:grid_dim]
    if any(int(s) < 2 * t + 1 for s in node_shape):
        return None
    interior = tuple(slice(t, -t) for _ in range(grid_dim))
    center = tuple(int(s) // 2 for s in node_shape)
    wcs = []
    for W in weights_np:
        W = np.asarray(W, dtype=np.float64)
        c = W[center]
        if not np.all(W[interior + (Ellipsis,)] == c):
            return None
        wcs.append(c)
    slabs_np = [[] for _ in range(2 * grid_dim)]
    for Wsrc in weights_np:
        W = np.asarray(Wsrc, dtype=np.float64)
        f = 0
        for axis in range(grid_dim):
            for side in (0, 1):
                idx = tuple(
                    (slice(0, t) if side == 0
                     else slice(node_shape[axis] - t, node_shape[axis]))
                    if a == axis else slice(None)
                    for a in range(grid_dim))
                slabs_np[f].append(W[idx + (Ellipsis,)])
                f += 1
    wc = jnp.asarray(np.stack(wcs), dtype=dtype)
    slabs = tuple(jnp.asarray(np.stack(sl), dtype=dtype) for sl in slabs_np)
    return CSOp(wc=wc, slabs=slabs)


def _apply_cs(offsets: Tuple[Offset, ...], op: CSOp, x: jnp.ndarray,
              grid_dim: int, vdim: int) -> jnp.ndarray:
    pad = [(1, 1)] * grid_dim + [(0, 0)] * (x.ndim - grid_dim)
    xp = jnp.pad(x, pad)
    shape = x.shape[:grid_dim]
    # Constant pass.  For blocks, expand into explicit scalar multiplies: an
    # einsum with a constant [v, v] matrix lowers to a matmul, which runs in
    # reduced precision by default on accelerators.
    if vdim == 1:
        y = None
        for i, off in enumerate(offsets):
            sl = tuple(slice(1 + o, 1 + o + s) for o, s in zip(off, shape))
            xs = xp[sl]
            term = op.wc[i] * xs
            y = term if y is None else y + term
    else:
        comps = [None] * vdim
        for i, off in enumerate(offsets):
            sl = tuple(slice(1 + o, 1 + o + s) for o, s in zip(off, shape))
            xs = xp[sl + (Ellipsis,)]
            for a in range(vdim):
                term = None
                for b in range(vdim):
                    tb = op.wc[i, a, b] * xs[..., b]
                    term = tb if term is None else term + tb
                comps[a] = term if comps[a] is None else comps[a] + term
        y = jnp.stack(comps, axis=-1)
    t = _CS_SHELL
    face = 0
    for axis in range(grid_dim):
        for side in (0, 1):
            SW = op.slabs[face]
            face += 1
            base = 1 if side == 0 else shape[axis] - t + 1
            ys = None
            for i, off in enumerate(offsets):
                sl = tuple(
                    slice(base + off[a], base + off[a] + t) if a == axis
                    else slice(1 + off[a], 1 + off[a] + shape[a])
                    for a in range(grid_dim))
                xs = xp[sl + (Ellipsis,)]
                term = (SW[i] * xs if vdim == 1
                        else block_matvec(SW[i], xs))
                ys = term if ys is None else ys + term
            set_idx = tuple(
                (slice(0, t) if side == 0 else slice(shape[a] - t, shape[a]))
                if a == axis else slice(None)
                for a in range(grid_dim))
            y = y.at[set_idx + (Ellipsis,)].set(ys)
    return y


def _stencil_apply(offsets: Tuple[Offset, ...], weights, x: jnp.ndarray,
                   grid_dim: int, vdim: int) -> jnp.ndarray:
    if isinstance(weights, CSOp):
        return _apply_cs(offsets, weights, x, grid_dim, vdim)
    pad = [(1, 1)] * grid_dim + [(0, 0)] * (x.ndim - grid_dim)
    xp = jnp.pad(x, pad)
    shape = x.shape[:grid_dim]
    y = None
    for off, W in zip(offsets, weights):
        sl = tuple(slice(1 + o, 1 + o + s) for o, s in zip(off, shape))
        xs = xp[sl + (Ellipsis,)]
        term = W * xs if vdim == 1 else block_matvec(W, xs)
        y = term if y is None else y + term
    return y


def _cg_unit_diag(offsets, weights, b, x0, tol, maxiter, grid_dim, vdim):
    """CG on the scaled (identity-diagonal) system — no preconditioner."""
    dtype = b.dtype

    def A(x):
        return _stencil_apply(offsets, weights, x, grid_dim, vdim)

    def dot(a, c):
        return jnp.vdot(a.reshape(-1), c.reshape(-1))

    x = x0
    r = b - A(x)
    p = r
    rz = dot(r, r)
    bnorm2 = dot(b, b)
    bnorm2 = jnp.where(bnorm2 == 0, jnp.asarray(1.0, dtype), bnorm2)
    tol2 = (tol * tol) * bnorm2

    def cond(state):
        _, _, _, rz, k = state
        return jnp.logical_and(rz > tol2, k < maxiter)

    def body(state):
        x, r, p, rz, k = state
        Ap = A(p)
        pAp = dot(p, Ap)
        alpha = rz / jnp.where(pAp == 0, jnp.asarray(1.0, dtype), pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        rz_new = dot(r, r)
        beta = rz_new / jnp.where(rz == 0, jnp.asarray(1.0, dtype), rz)
        return x, r, r + beta * p, rz_new, k + 1

    x, r, p, rz, k = jax.lax.while_loop(
        cond, body, (x, r, p, rz, jnp.asarray(0, jnp.int32)))
    relres = jnp.sqrt(rz / bnorm2)
    return x, k, relres


@partial(jax.jit, static_argnames=("offsets", "grid_dim", "vdim"))
def _jit_cg(offsets, weights, b, x0, tol, maxiter, grid_dim, vdim):
    return _cg_unit_diag(offsets, weights, b, x0, tol,
                         jnp.asarray(maxiter, jnp.int32), grid_dim, vdim)


@partial(jax.jit, static_argnames=("offsets", "grid_dim", "vdim"))
def _jit_residual64(offsets, weights64, b64, x64, grid_dim, vdim):
    """r = b - A x in f64; returns (r scaled to f32, ||r||², scale)."""
    r = b64 - _stencil_apply(offsets, weights64, x64, grid_dim, vdim)
    rnorm2 = jnp.vdot(r.reshape(-1), r.reshape(-1))
    scale = jnp.maximum(jnp.max(jnp.abs(r)), 1e-300)
    return (r / scale).astype(jnp.float32), rnorm2, scale


@jax.jit
def _jit_axpy64(x64, scale, d32):
    return x64 + scale * d32.astype(jnp.float64)


def device_operator(offsets: Tuple[Offset, ...], weights_np, grid_dim: int,
                    vdim: int, dtype):
    """Device form of a scaled stencil: CSOp when translation-invariant,
    dense weight tuple otherwise.  Either feeds :func:`_stencil_apply`."""
    cs = make_cs_op(offsets, weights_np, grid_dim, vdim, dtype)
    if cs is not None:
        return cs
    return tuple(jnp.asarray(W, dtype=dtype) for W in weights_np)


# ----------------------------------------------------------------------
# Public facade
# ----------------------------------------------------------------------

# ----------------------------------------------------------------------
# MG operator cache: hierarchy + df-ladder weight parts keyed by CONTENT
# (node shape, offsets, scaled-weight + free-mask bytes).  Repeated solves
# of the same discrete system — bench warm/timed pairs, agent follow-up
# queries that only change BC values or the RHS — skip the per-call
# hierarchy rebuild + weight re-upload.  BC *values* are not part of
# the operator (masking bakes in the free PATTERN only; values enter
# through b̂), so value-only follow-ups hit the cache.
# ----------------------------------------------------------------------

_MG_CACHE: Dict = {}
_MG_CACHE_MAX = 2


def _mg_cache_key(mesh: StructuredMesh, vdim: int, prec: str,
                  sysm: ScaledSystem):
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for W in sysm.weights:
        h.update(np.ascontiguousarray(W))
    h.update(np.ascontiguousarray(sysm.free))
    return (mesh.node_shape, vdim, prec, sysm.offsets, h.hexdigest())


def _mg_cache_get(key):
    entry = _MG_CACHE.pop(key, None)
    if entry is not None:
        _MG_CACHE[key] = entry  # LRU refresh
    return entry


def _mg_cache_put(key, entry):
    _MG_CACHE[key] = entry
    while len(_MG_CACHE) > _MG_CACHE_MAX:
        _MG_CACHE.pop(next(iter(_MG_CACHE)))


def _host_direct_solve(sysm: ScaledSystem, node_shape, vdim: int):
    """Sparse-LU the scaled hat system on host (float64, exact).

    C-order DOF numbering matching ``grid.reshape(-1)``; the assembled
    weights carry exact zeros wherever a flat shift would wrap across a
    grid row, so flat-index column arithmetic is valid (see ops.assembly
    invariant)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    N = int(np.prod(node_shape))
    strides = []
    acc = 1
    for s in reversed(node_shape):
        strides.append(acc)
        acc *= s
    strides = list(reversed(strides))
    base = np.arange(N)
    rows_l, cols_l, vals_l = [], [], []
    for off, W in zip(sysm.offsets, sysm.weights):
        delta = int(sum(o * st for o, st in zip(off, strides)))
        cols = base + delta
        valid = (cols >= 0) & (cols < N)
        Wf = (np.asarray(W, np.float64).reshape(N, vdim, vdim) if vdim > 1
              else np.asarray(W, np.float64).reshape(N, 1, 1))
        r, c = base[valid], cols[valid]
        for a in range(vdim):
            for b_ in range(vdim):
                rows_l.append(r * vdim + a)
                cols_l.append(c * vdim + b_)
                vals_l.append(Wf[valid, a, b_])
    n = N * vdim
    A = sp.csr_matrix((np.concatenate(vals_l),
                       (np.concatenate(rows_l), np.concatenate(cols_l))),
                      shape=(n, n))
    b = np.asarray(sysm.b_hat, np.float64).reshape(-1)
    x = spla.spsolve(A, b)
    bn = np.linalg.norm(b)
    relres = np.linalg.norm(b - A @ x) / (bn if bn > 0 else 1.0)
    return x.reshape(sysm.b_hat.shape), float(relres)


def solve_stencil_system(
    stencil_np: Dict,
    mesh: StructuredMesh,
    bc: DirichletBC,
    rhs_np: np.ndarray,
    vdim: int = 1,
    config: Optional[SolverConfig] = None,
    x0: Optional[np.ndarray] = None,
    mg_level_builder=None,
) -> Tuple[np.ndarray, SolveStats]:
    """Solve A x = b with Dirichlet symmetric elimination.

    ``stencil_np``: numpy stencil from ``ops.assembly``; ``rhs_np``: the raw
    (unconstrained) load vector.  ``mg_level_builder(mesh_c) → (stencil, bc)``
    enables geometric-multigrid preconditioning (ops.multigrid) for large
    systems.  Returns (x float64 numpy grid, stats).
    """
    from pde_solver.utils.observability import phase_timer

    cfg = config or get_config()
    prec = cfg.resolve_precision()
    d = mesh.dim
    n = int(np.prod(mesh.node_shape)) * vdim
    maxiter = cfg.resolved_maxiter(n)
    # prepare / hierarchy (build + upload) / ladder (df pairs upload) /
    # iterate (the device solve proper) — attached to the returned stats
    phases: Dict[str, float] = {}

    with phase_timer(phases, "prepare"):
        sysm = prepare_system(stencil_np, mesh, bc, rhs_np, vdim)
    offsets = sysm.offsets
    x0_hat = (np.zeros_like(sysm.b_hat) if x0 is None
              else sysm.to_hat_x(np.asarray(x0, dtype=np.float64)))

    # Tiny systems: host sparse LU, no device round-trips (the explicit
    # sharding request below still wins — its tests exercise small meshes).
    if (0 < n <= cfg.host_direct_threshold
            and cfg.resolved_shard_devices() <= 1):
        try:
            xh, relres = _host_direct_solve(sysm, mesh.node_shape, vdim)
        except ImportError:
            pass  # scipy unavailable → fall through to the device paths
        else:
            x = sysm.from_hat_x(xh)
            return x, SolveStats(iterations=np.int32(1),
                                 relative_residual=np.float64(relres),
                                 converged=np.bool_(relres <= 1e-9),
                                 target=1e-9, phases=phases)

    nshard = cfg.resolved_shard_devices()
    use_mg = (mg_level_builder is not None and cfg.use_multigrid
              and n >= cfg.mg_threshold)
    if prec == "mixed" and nshard > 1 and use_mg:
        # Sharded MG has no double-f32 ladder, and host-f64 refinement of
        # f32 MG-PCG gains only ~5x per round on the 2M-DOF cantilever,
        # sharded or not (benchmarks/f32_refinement.py): run sharded MG-PCG
        # in float64.
        prec = "f64"
    hierarchy = None
    ladder_core = None
    hier_key = None
    if use_mg:
        import time as _time

        from pde_solver.ops import multigrid as mg
        from pde_solver.utils.observability import get_logger
        t_h = _time.perf_counter()
        with phase_timer(phases, "hierarchy"):
            hier_key = _mg_cache_key(mesh, vdim, prec, sysm) + (nshard > 1,)
            cached = _mg_cache_get(hier_key)
            if cached is not None:
                hierarchy, ladder_core = cached
            else:
                mg_dtype = jnp.float64 if prec == "f64" else jnp.float32
                hierarchy = mg.build_hierarchy_cached(
                    mesh, sysm, mg_level_builder, vdim=vdim, dtype=mg_dtype,
                    cache_key=sysm.ckey)
                if hierarchy is not None:
                    _mg_cache_put(hier_key, (hierarchy, None))
                    jax.block_until_ready(
                        [lv.weights for lv in hierarchy.levels])
        get_logger().info("hierarchy %s: %.3fs (%d DOF)",
                          "cache hit" if cached is not None else "build",
                          _time.perf_counter() - t_h, n)

    # Domain decomposition over a device mesh (SolverConfig.shard_devices).
    # With a hierarchy the two COMPOSE: the V-cycle runs under GSPMD with
    # per-level sharded arrays (parallel.shard_mg).  Without one, the scaled
    # system runs hand-shard_mapped CG (parallel.shard.ShardedScaledCG).
    sharded = None
    sharded_mg = None
    if nshard > 1 and hierarchy is not None:
        from pde_solver.parallel.shard import device_mesh
        from pde_solver.parallel.shard_mg import shard_hierarchy
        from pde_solver.utils.observability import get_logger
        sharded_mg = shard_hierarchy(hierarchy, device_mesh(nshard),
                                     key=hier_key)
        get_logger().info(
            "sharded MG-PCG: V-cycle + domain decomposition over %d devices",
            nshard)
    elif nshard > 1:
        from pde_solver.parallel.shard import ShardedScaledCG, device_mesh
        sh_dtype = jnp.float64 if prec == "f64" else jnp.float32
        # 2-D decomposition (grid axes 0+1 over an a×b device mesh) when
        # requested and the problem has a second grid axis; otherwise the
        # 1-D slab split
        grid2d = cfg.resolved_shard_grid() if d >= 2 else None
        mesh_dev = (device_mesh(shape=grid2d) if grid2d is not None
                    else device_mesh(nshard))
        sharded = ShardedScaledCG(sysm, d, vdim, mesh_dev, dtype=sh_dtype)

    if prec == "f64":
        if sharded_mg is not None:
            from pde_solver.parallel.shard_mg import solve_mg_sharded
            xh, k, relres = solve_mg_sharded(sharded_mg, sysm.b_hat, x0_hat,
                                             cfg.tol, cfg.mg_maxiter)
        elif hierarchy is not None:
            from pde_solver.ops.multigrid import solve_mg
            xh, k, relres = solve_mg(hierarchy, sysm.b_hat, x0_hat,
                                     cfg.tol, cfg.mg_maxiter)
        elif sharded is not None:
            xh, k, relres = sharded.solve(x0=x0_hat, tol=cfg.tol,
                                          maxiter=maxiter)
        else:
            w64 = tuple(jnp.asarray(W, dtype=jnp.float64) for W in sysm.weights)
            xh, k, relres = _jit_cg(offsets, w64, jnp.asarray(sysm.b_hat),
                                    jnp.asarray(x0_hat), cfg.tol, maxiter, d,
                                    vdim)
        tol_used = cfg.tol
        iters = int(k)
        relres = float(relres)
        x_hat = np.asarray(xh, dtype=np.float64)
    elif prec == "f32":
        w32 = tuple(jnp.asarray(W, dtype=jnp.float32) for W in sysm.weights)
        tol_used = max(cfg.inner_tol, 1e-7)
        if sharded_mg is not None:
            from pde_solver.parallel.shard_mg import solve_mg_sharded
            xh, k, relres = solve_mg_sharded(
                sharded_mg, sysm.b_hat.astype(np.float32),
                x0_hat.astype(np.float32), tol_used, cfg.mg_maxiter)
        elif sharded is not None:
            xh, k, relres = sharded.solve(x0=x0_hat.astype(np.float32),
                                          tol=tol_used, maxiter=maxiter)
        else:
            xh, k, relres = _jit_cg(offsets, w32,
                                    jnp.asarray(sysm.b_hat, dtype=jnp.float32),
                                    jnp.asarray(x0_hat, dtype=jnp.float32),
                                    tol_used, maxiter, d, vdim)
        iters = int(k)
        relres = float(relres)
        x_hat = np.asarray(xh, dtype=np.float64)
    else:  # mixed: f32 CG on device + float64 refinement on host.
        # The f64 residual runs in host numpy against the host copy of the
        # scaled weights, so no double-precision weights are uploaded; per
        # round only the f32 residual/correction vectors cross to the host.
        if hierarchy is not None:
            # Double-float32 F-cycle (ops.multigrid): Galerkin ladder with an
            # exact f64 coarsest anchor and error-free-transformation defects
            # at the finest level — beats the κ_eff·ε32 floor that stalls a
            # plain f32 refinement loop on ill-conditioned problems.
            from pde_solver.ops import df32
            from pde_solver.ops.multigrid import (build_df_ladder,
                                                      solve_fcycle_df2)
            from pde_solver.ops.multigrid import ladder_with_b
            with phase_timer(phases, "ladder"):
                if ladder_core is not None:
                    ladder = ladder_with_b(ladder_core, sysm.b_hat)
                else:
                    ladder = build_df_ladder(hierarchy, sysm, sysm.b_hat)
                    if hier_key is not None:
                        _mg_cache_put(hier_key, (hierarchy, ladder))
                jax.block_until_ready(ladder)
            # per-round-fused df2: ONE program + ONE scalar pull per round
            # (the host-driven df variant pays ~10 dispatches per round)
            with phase_timer(phases, "iterate"):
                x_hi, x_lo, iters, relres = solve_fcycle_df2(
                    hierarchy, ladder, max(cfg.tol, 1e-9),
                    max_rounds=max(cfg.refine_rounds, 8))
                x_hat = df32.df_to_f64(np.asarray(x_hi), np.asarray(x_lo))
            x = sysm.from_hat_x(x_hat)
            target = max(cfg.tol, cfg.accuracy_target)
            stats = SolveStats(
                iterations=np.int32(iters),
                relative_residual=np.float64(relres),
                converged=bool(relres <= target),
                target=target,
                phases=phases,
            )
            return x, stats
        elif sharded is not None:
            def inner_solve(r32):
                return sharded.solve(b_hat=r32, tol=cfg.inner_tol,
                                     maxiter=maxiter)
        else:
            w32 = tuple(jnp.asarray(W, dtype=jnp.float32)
                        for W in sysm.weights)

            def inner_solve(r32):
                return _jit_cg(offsets, w32, jnp.asarray(r32, jnp.float32),
                               jnp.zeros(r32.shape, jnp.float32),
                               cfg.inner_tol, maxiter, d, vdim)

        scaled_np = {o: W for o, W in zip(offsets, sysm.weights)}
        x_hat = np.asarray(x0_hat, dtype=np.float64)
        bnorm = float(np.linalg.norm(sysm.b_hat.reshape(-1)))
        tol_used = cfg.tol
        iters = 0
        relres = 1.0
        if bnorm == 0.0:
            x_hat = np.zeros_like(sysm.b_hat)
            relres = 0.0
        else:
            for _ in range(cfg.refine_rounds):
                r = sysm.b_hat - np_stencil_apply(scaled_np, x_hat, d, vdim)
                relres = float(np.linalg.norm(r.reshape(-1))) / bnorm
                if relres <= cfg.tol or not np.isfinite(relres):
                    break
                scale = float(np.max(np.abs(r)))
                d32, k, _ = inner_solve(np.asarray(r / scale, dtype=np.float32))
                x_hat = x_hat + scale * np.asarray(d32, dtype=np.float64)
                iters += int(k)
            else:
                r = sysm.b_hat - np_stencil_apply(scaled_np, x_hat, d, vdim)
                relres = float(np.linalg.norm(r.reshape(-1))) / bnorm

    x = sysm.from_hat_x(x_hat)
    # Explicit verdict: "converged" = the residual met the larger of the
    # requested tolerance and the framework accuracy contract (previously a
    # silent tol·100 slack — a solve could claim convergence two orders
    # above its target without surfacing it anywhere).
    target = max(tol_used, cfg.accuracy_target)
    stats = SolveStats(
        iterations=np.int32(iters),
        relative_residual=np.float64(relres),
        converged=bool(np.float64(relres) <= target),
        target=target,
        phases=phases,
    )
    return x, stats
