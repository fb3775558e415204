"""Geometric multigrid preconditioned CG on structured stencil systems.

The structured meshes coarsen trivially (cells halved per axis), so a
matrix-free V-cycle is natural: per level a scaled stencil operator
(see ops.linsolve — masking + (block-)diagonal scaling baked in, identity
diagonal), damped-Jacobi smoothing (x̂ += ω r̂ — the diagonal is identity),
and separable linear interpolation / full-weighting transfers implemented as
slice arithmetic.  Everything is float32 and device-resident; one V-cycle
costs a few fine-SpMV equivalents and cuts CG iteration counts by 10-100×
versus (block-)Jacobi alone — the difference between minutes and seconds at
the 2M-DOF elasticity target (BASELINE.md config 5).

Scaling-aware transfers: with x = S x̂ per level (S = diag(s), or S = C^{-T}
for block-Cholesky scaling), Galerkin-consistent transfers are
P̂ = S_f^{-1} P S_c and R̂ = P̂ᵀ — realized as elementwise / 3×3-block
multiplies around the plain interpolation P.

The V-cycle is symmetric (same pre/post smoothing, R̂ = P̂ᵀ), hence a valid
SPD preconditioner for CG.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pde_solver.mesh import StructuredMesh
from pde_solver.ops.bc import DirichletBC
from pde_solver.ops.linsolve import ScaledSystem, _stencil_apply, prepare_system
from pde_solver.ops.stencil import block_matvec

Offset = Tuple[int, ...]


# ----------------------------------------------------------------------
# Transfers (separable, structured, factor 2 per axis)
# ----------------------------------------------------------------------

def _parities(grid_dim: int):
    import itertools
    return list(itertools.product((0, 1), repeat=grid_dim))


def _bisection_edges(grid_dim: int):
    """Freudenthal/right-diagonal triangulation edge directions: the axes
    plus the *consistent-orientation* diagonals only (each fine node with
    parity p bisects the edge along +p)."""
    return [p for p in _parities(grid_dim) if any(p)]


def _edge_stencil_apply(x: jnp.ndarray, grid_dim: int) -> jnp.ndarray:
    """y = x + ½ Σ_e (x shifted ±e), e over the bisection edges, zero-padded.

    The common factor of both transfer operators (see :func:`prolong`):
    15 plain shifted-slice adds in 3D — no strided access, so XLA fuses it
    into a few dense passes.  The previous 8-parity stride-2 gather/scatter
    formulation cost ~20 ms per transfer at 2M DOF (lane-strided relayouts);
    this form plus ONE strided up/downsample measures ~20× cheaper."""
    shape = x.shape[:grid_dim]
    pad = [(1, 1)] * grid_dim + [(0, 0)] * (x.ndim - grid_dim)
    xp = jnp.pad(x, pad)
    y = x
    for e in _bisection_edges(grid_dim):
        sl_p = tuple(slice(1 + o, 1 + o + s) for o, s in zip(e, shape))
        sl_m = tuple(slice(1 - o, 1 - o + s) for o, s in zip(e, shape))
        y = y + 0.5 * (xp[sl_p + (Ellipsis,)] + xp[sl_m + (Ellipsis,)])
    return y


def prolong(v: jnp.ndarray, grid_dim: int) -> jnp.ndarray:
    """Simplicial P1 interpolation on the Freudenthal/right-diagonal split.

    Every fine node bisects a *triangulation edge* (or coincides with a
    coarse node): the fine node at 2c+p gets ½(v[c] + v[c+p]) — including
    the (1,1)/(1,1,1) parities, which average along the cell diagonal
    rather than over all corners.  This makes the coarse P1 space exactly
    nested in the fine one, so the re-assembled coarse operator equals the
    Galerkin operator PᵀAP — the property the coarse-grid correction needs
    (separable trilinear interpolation broke it and stalled the V-cycle on
    elasticity).

    Computed as  S ⊛ upsample₂(v)  where S is the constant 15-point edge
    stencil: zeros at non-coarse sites make every non-edge term vanish
    (e ≡ p (mod 2) ⟺ e = p for 0/1 vectors)."""
    return _edge_stencil_apply(_upsample2(v, grid_dim), grid_dim)


def _upsample2(v: jnp.ndarray, grid_dim: int) -> jnp.ndarray:
    """Zeros at odd sites, axis by axis — stack+reshape instead of a strided
    `.at[::2,...].set` scatter."""
    for ax in range(grid_dim):
        s = v.shape[ax]
        w = jnp.stack([v, jnp.zeros_like(v)], axis=ax + 1)
        w = w.reshape(v.shape[:ax] + (2 * s,) + v.shape[ax + 1:])
        v = jax.lax.slice_in_dim(w, 0, 2 * s - 1, axis=ax)
    return v


def _downsample2(r: jnp.ndarray, grid_dim: int) -> jnp.ndarray:
    """Keep even sites, axis by axis — pad+reshape (see :func:`_upsample2`)."""
    for ax in range(grid_dim):
        s = r.shape[ax]                      # odd: 2m+1
        pad = [(0, 0)] * r.ndim
        pad[ax] = (0, 1)
        w = jnp.pad(r, pad)
        w = w.reshape(r.shape[:ax] + ((s + 1) // 2, 2) + r.shape[ax + 1:])
        r = jax.lax.index_in_dim(w, 0, axis=ax + 1, keepdims=False)
    return r


def restrict(r: jnp.ndarray, grid_dim: int) -> jnp.ndarray:
    """Adjoint of :func:`prolong` (unnormalized full weighting on the
    triangulation edges):  downsample₂(S ⊛ r)."""
    return _downsample2(_edge_stencil_apply(r, grid_dim), grid_dim)


# ----------------------------------------------------------------------
# Hierarchy
# ----------------------------------------------------------------------

class MGLevel(NamedTuple):
    offsets: Tuple[Offset, ...]
    weights: Tuple[jnp.ndarray, ...]     # scaled stencil (f32) — the true
                                         # operator (outer CG residuals)
    free: jnp.ndarray                    # f32 mask over DOFs
    omega: float                         # damped-Jacobi weight
    # hat↔physical scale hooks for transfers:
    s: Optional[jnp.ndarray]             # scalar 1/sqrt(diag); None for block
    C: Optional[jnp.ndarray]             # block Cholesky factor [.., v, v]
    Cinv: Optional[jnp.ndarray]
    Ainv: Optional[jnp.ndarray] = None   # dense inverse (coarsest level only)
    host_weights: Optional[list] = None  # f64 numpy copies (nested refinement)
    host_Ainv: Optional[np.ndarray] = None
    host_scale: Optional[tuple] = None   # (s,) or (C, Cinv) f64 numpy
    # (hi, lo) f32 numpy pairs of host_weights — populated by the disk-cache
    # rebuild path so build_df_ladder skips the df split (the pair IS what
    # the ladder uploads; splitting hi+lo again reproduces it bit-exactly).
    host_pairs: Optional[tuple] = None
    # Constant-interior split of the (hi, lo) pair, numpy:
    # (wc_hi, wc_lo, [slab_hi per face], [slab_lo per face]).  Populated for
    # translation-invariant levels; build_df_ladder uploads THIS (a few
    # hundred scalars + thickness-2 face slabs) and expands it on device
    # instead of uploading the dense pairs.
    host_cs: Optional[tuple] = None
    # Dense per-offset DEVICE (Whi, Wlo) tuples expanded from ``host_cs`` by
    # the disk-cache rebuild — build_df_ladder consumes these directly so
    # the pair is expanded ONCE per process.
    dev_pairs: Optional[tuple] = None


class MGHierarchy(NamedTuple):
    levels: Tuple[MGLevel, ...]          # finest first
    grid_dim: int
    vdim: int
    pre_smooth: int
    post_smooth: int
    coarse_iters: int  # fallback only — used when no dense inverse fits


def dense_from_stencil(offsets, weights, node_shape, vdim: int) -> np.ndarray:
    """Densify a stencil into [N·v, N·v] with C-order DOF numbering
    (matching ``grid.reshape(-1)``)."""
    N = int(np.prod(node_shape))
    strides = []
    acc = 1
    for s in reversed(node_shape):
        strides.append(acc)
        acc *= s
    strides = list(reversed(strides))
    n = N * vdim
    A = np.zeros((n, n))
    rows = np.arange(N)
    for off, W in zip(offsets, weights):
        delta = int(sum(o * st for o, st in zip(off, strides)))
        cols = rows + delta
        valid = (cols >= 0) & (cols < N)
        Wf = (np.asarray(W, np.float64).reshape(N, vdim, vdim) if vdim > 1
              else np.asarray(W, np.float64).reshape(N, 1, 1))
        r, c = rows[valid], cols[valid]
        for a in range(vdim):
            for b in range(vdim):
                A[r * vdim + a, c * vdim + b] += Wf[valid, a, b]
    return A


def can_coarsen(mesh: StructuredMesh, min_cells: int = 2) -> bool:
    return all(c % 2 == 0 and c // 2 >= min_cells for c in mesh.n_cells)


def coarsen_mesh(mesh: StructuredMesh) -> StructuredMesh:
    return StructuredMesh(tuple(c // 2 for c in mesh.n_cells),
                          mesh.origin, mesh.extent)


@partial(jax.jit, static_argnames=("offsets", "grid_dim", "vdim", "iters"))
def _power_iteration(offsets, weights, x, grid_dim, vdim, iters):
    def body(_, state):
        x, _ = state
        y = _stencil_apply(offsets, weights, x, grid_dim, vdim)
        n = jnp.sqrt(jnp.vdot(y.reshape(-1), y.reshape(-1)))
        return y / jnp.maximum(n, 1e-30), n

    _, lam = jax.lax.fori_loop(0, iters, body, (x, jnp.asarray(2.0, x.dtype)))
    return lam


def _estimate_lambda_max(offsets, weights, shape, grid_dim, vdim,
                         iters: int = 10, dtype=jnp.float32) -> float:
    """Power iteration on the scaled operator (setup only).  Weights are jit
    *arguments*: closing over large device arrays would embed them in the
    compiled program as constants."""
    rng = np.random.default_rng(0)
    full_shape = shape + ((vdim,) if vdim > 1 else ())
    x = jnp.asarray(rng.standard_normal(full_shape), dtype=dtype)
    lam = float(_power_iteration(offsets, weights, x, grid_dim, vdim, iters))
    return max(lam, 1e-6)


def _to_level(sysm: ScaledSystem, mesh: StructuredMesh, vdim: int,
              dtype, omega: Optional[float] = None,
              pairs: Optional[tuple] = None,
              defer_omega: bool = False) -> MGLevel:
    """Build one MG level's device operators from a scaled system.

    ``defer_omega=True`` leaves ``omega=None`` in the returned level so the
    caller (:func:`build_hierarchy`) can batch ALL levels' λmax power
    iterations into one device→host pull."""
    host_w = [np.asarray(W, dtype=np.float64) for W in sysm.weights]
    free = jnp.asarray(sysm.free, dtype=dtype)
    # weight source for the device operator: the cached hi pair equals
    # f32(weights) bit-exactly and skips an f64→f32 conversion pass
    w_src = pairs[0] if pairs is not None else sysm.weights
    w = tuple(jnp.asarray(W, dtype=dtype) for W in w_src)
    if omega is None and not defer_omega:
        # λmax must be estimated per level: Chebyshev smoothing *diverges* on
        # any eigenvalue above its assumed λmax, so guessing is not safe.  The
        # 1.05 factor covers power-iteration underestimation.
        lam = 1.05 * _estimate_lambda_max(sysm.offsets, w, mesh.node_shape,
                                          mesh.dim, vdim, dtype=dtype)
        omega = float(4.0 / (3.0 * lam))  # λmax recoverable as 4/(3ω)
    if sysm.scale_kind == "scalar":
        return MGLevel(sysm.offsets, w, free, omega,
                       jnp.asarray(sysm.s, dtype=dtype), None, None,
                       host_weights=host_w, host_scale=(np.asarray(sysm.s),),
                       host_pairs=pairs)
    C_np = np.swapaxes(sysm.Ct, -1, -2)
    Cinv_np = np.swapaxes(sysm.CinvT, -1, -2)
    C = jnp.asarray(C_np, dtype=dtype)
    Cinv = jnp.asarray(Cinv_np, dtype=dtype)
    return MGLevel(sysm.offsets, w, free, omega, None, C, Cinv,
                   host_weights=host_w, host_scale=(C_np, Cinv_np),
                   host_pairs=pairs)


def build_hierarchy(
    mesh: StructuredMesh,
    fine_system: ScaledSystem,
    level_builder: Callable[[StructuredMesh], Tuple[Dict, DirichletBC]],
    vdim: int = 1,
    max_levels: int = 10,
    pre_smooth: int = 2,
    post_smooth: int = 2,
    coarse_iters: int = 60,
    dtype=jnp.float32,
) -> Optional[MGHierarchy]:
    """Build the level stack.  ``level_builder(mesh_c)`` re-assembles the
    operator + BCs on a coarse mesh (exact for the constant / coordinate-
    weight coefficients used by this framework).  Returns None when the fine
    mesh cannot coarsen (odd cell counts).

    ``PDE_MG_SMOOTH="pre,post"`` overrides the Chebyshev smoothing
    degrees for experiments (e.g. the bench's V(2,1) flagship cycle).
    The default stays the symmetric V(2,2): an
    asymmetric cycle is a (mildly) nonsymmetric preconditioner, kept
    opt-in for the general solver paths."""
    import os as _os
    env_smooth = _os.environ.get("PDE_MG_SMOOTH", "")
    if env_smooth:
        pre_smooth, post_smooth = (int(x) for x in env_smooth.split(","))
    if not can_coarsen(mesh):
        return None
    levels = [_to_level(fine_system, mesh, vdim, dtype, defer_omega=True)]
    meshes = [mesh]
    cur = mesh
    cur_sys = fine_system
    while len(levels) < max_levels and can_coarsen(cur):
        cur = coarsen_mesh(cur)
        stencil_c, bc_c = level_builder(cur)
        cur_sys = prepare_system(stencil_c, cur, bc_c, _zeros_shape(cur, vdim),
                                 vdim)
        levels.append(_to_level(cur_sys, cur, vdim, dtype, defer_omega=True))
        meshes.append(cur)
    # Batched λmax: dispatch every level's power iteration, then resolve all
    # of them through ONE device→host pull — one synchronization point for
    # the whole hierarchy.
    lam_devs = []
    for lv, m in zip(levels, meshes):
        # fresh seed-0 rng per level — parity with the sequential
        # _estimate_lambda_max calls this replaces
        rng = np.random.default_rng(0)
        full_shape = m.node_shape + ((vdim,) if vdim > 1 else ())
        x = jnp.asarray(rng.standard_normal(full_shape), dtype=dtype)
        lam_devs.append(_power_iteration(lv.offsets, lv.weights, x,
                                         mesh.dim, vdim, 10))
    lams = np.asarray(jnp.stack(lam_devs))
    for i in range(len(levels)):
        lam = 1.05 * max(float(lams[i]), 1e-6)
        levels[i] = levels[i]._replace(omega=float(4.0 / (3.0 * lam)))
    # Exact dense inverse at the coarsest level: an iterative coarse "solve"
    # leaves the preconditioner non-SPD (observed: negative M⁻¹ eigenvalues →
    # PCG breakdown at scale).  Coarsest systems here are tiny (≤ few k DOF).
    n_coarse = int(np.prod(cur.node_shape)) * vdim
    if n_coarse <= 20000:
        A_dense = dense_from_stencil(cur_sys.offsets, cur_sys.weights,
                                     cur.node_shape, vdim)
        Ainv = np.linalg.inv(A_dense)
        levels[-1] = levels[-1]._replace(Ainv=jnp.asarray(Ainv, dtype=dtype),
                                         host_Ainv=Ainv)
    return MGHierarchy(tuple(levels), mesh.dim, vdim, pre_smooth,
                       post_smooth, coarse_iters)


def _zeros_shape(mesh: StructuredMesh, vdim: int):
    shape = mesh.node_shape + ((vdim,) if vdim > 1 else ())
    return np.zeros(shape)


# ----------------------------------------------------------------------
# Disk-backed hierarchy build (fresh-process setup skip)
# ----------------------------------------------------------------------
#
# A hierarchy is a pure function of the fine scaled system, so it persists
# across processes keyed by the fine system's content hash
# (ScaledSystem.ckey / linsolve._mg_cache_key).  The disk entry stores the
# per-level double-f32 weight pairs (hi ≡ the f32 device weights; hi+lo
# carries the f64 operator to 2⁻⁴⁸ — exactly what the df ladder uploads),
# the transfer scales, free masks, cached λmax-derived ω per level (skipping
# the per-level device power iterations), and the dense coarsest inverse.
# A cached rebuild does no host numerics — only device uploads.  f32 only:
# the f64 (CPU-test) path must not round-trip through f32 pairs.

class _ShapeOnlyMesh:
    """Minimal mesh stand-in for :func:`_to_level` (node_shape + dim)."""

    def __init__(self, node_shape):
        self.node_shape = tuple(int(s) for s in node_shape)
        self.dim = len(self.node_shape)


def _cs_face_index(node_shape, grid_dim: int, face: int):
    """Slab index (leading n_off axis) for face f = 2·axis + side."""
    from pde_solver.ops.linsolve import _CS_SHELL
    axis, side = divmod(face, 2)
    t = _CS_SHELL
    return (slice(None),) + tuple(
        (slice(0, t) if side == 0
         else slice(node_shape[a] - t, node_shape[a]))
        if a == axis else slice(None)
        for a in range(grid_dim))


def _cs_split_np(host_weights64, grid_dim: int):
    """Constant-interior split of stacked f64 weights (host, numpy):
    returns (wc64 [n_off(,v,v)], [slab64 per face]) or None when the stencil
    is not exactly translation-invariant on the strict interior."""
    from pde_solver.ops.linsolve import _CS_SHELL
    t = _CS_SHELL
    W0 = np.asarray(host_weights64[0])
    node_shape = W0.shape[:grid_dim]
    if any(int(s) < 2 * t + 1 for s in node_shape):
        return None
    interior = tuple(slice(t, -t) for _ in range(grid_dim))
    center = tuple(int(s) // 2 for s in node_shape)
    wcs = []
    for W in host_weights64:
        W = np.asarray(W, dtype=np.float64)
        c = W[center]
        if not np.all(W[interior + (Ellipsis,)] == c):
            return None
        wcs.append(c)
    stacked = np.stack([np.asarray(W, np.float64) for W in host_weights64])
    slabs = [stacked[_cs_face_index(node_shape, grid_dim, f)]
             for f in range(2 * grid_dim)]
    return np.stack(wcs), slabs


def _hierarchy_to_arrays(h: MGHierarchy):
    """Serialize a hierarchy (host side) → (arrays dict, meta dict, pairs).

    Translation-invariant levels (uniform coefficients — the common case)
    store the CONSTANT-INTERIOR split: a few hundred scalars + thickness-2
    boundary face slabs, ~6× smaller than the dense weights AND expandable
    on device.  Non-invariant levels (composite
    coefficients) fall back to dense (hi, lo) pairs."""
    from pde_solver.ops import df32

    arrays = {}
    omegas = []
    shapes = []
    cs_flags = []
    all_pairs = []
    all_cs = []
    scale_kind = "scalar" if h.levels[0].s is not None else "block"
    for i, lv in enumerate(h.levels):
        if lv.host_cs is not None:
            # the fresh compact build already split this level — reuse
            # (the scan over the dense f64 weights is the expensive part)
            wc_hi, wc_lo, shi_l, slo_l = lv.host_cs
            cs = (wc_hi, shi_l)  # non-None marker; parts stored below
        else:
            cs = _cs_split_np(lv.host_weights, h.grid_dim)
            if cs is not None:
                wc64, slabs64 = cs
                wc_hi, wc_lo = df32.df_from_f64(wc64)
                shi_l, slo_l = [], []
                for slab in slabs64:
                    shi, slo = df32.df_from_f64(slab)
                    shi_l.append(shi)
                    slo_l.append(slo)
        if cs is not None:
            arrays[f"cswchi{i}"] = wc_hi
            arrays[f"cswclo{i}"] = wc_lo
            for f in range(len(shi_l)):
                arrays[f"csshi{i}_{f}"] = shi_l[f]
                arrays[f"csslo{i}_{f}"] = slo_l[f]
            cs_flags.append(True)
            all_pairs.append(None)
            all_cs.append((wc_hi, wc_lo, shi_l, slo_l))
        else:
            if lv.host_pairs is not None:
                his, los = lv.host_pairs
            else:
                his, los = [], []
                for W in lv.host_weights:
                    hi, lo = df32.df_from_f64(W)
                    his.append(hi)
                    los.append(lo)
            all_pairs.append((list(his), list(los)))
            all_cs.append(None)
            arrays[f"hi{i}"] = np.stack(his)
            arrays[f"lo{i}"] = np.stack(los)
            cs_flags.append(False)
        arrays[f"off{i}"] = np.asarray(lv.offsets, dtype=np.int64)
        arrays[f"free{i}"] = np.asarray(lv.free, dtype=np.float32)
        if scale_kind == "scalar":
            arrays[f"s{i}"] = np.asarray(lv.host_scale[0])
        else:
            arrays[f"C{i}"] = np.asarray(lv.host_scale[0])
            arrays[f"Cinv{i}"] = np.asarray(lv.host_scale[1])
        omegas.append(float(lv.omega))
        shapes.append(list(np.asarray(lv.free).shape[:h.grid_dim]))
    if h.levels[-1].host_Ainv is not None:
        arrays["Ainv"] = np.asarray(h.levels[-1].host_Ainv)
    meta = {"n_levels": len(h.levels), "grid_dim": h.grid_dim,
            "vdim": h.vdim, "pre": h.pre_smooth, "post": h.post_smooth,
            "coarse_iters": h.coarse_iters, "scale_kind": scale_kind,
            "omegas": omegas, "node_shapes": shapes, "cs": cs_flags}
    return arrays, meta, all_pairs, all_cs


def _expand_cs_np(wc: np.ndarray, slabs, node_shape, grid_dim: int
                  ) -> np.ndarray:
    """Host expansion of a CS split — pure memcpy-grade numpy (broadcast the
    constant interior, overwrite the exact face slabs).  Bit-identical to
    the dense weights the split came from."""
    n_off = wc.shape[0]
    tail = wc.shape[1:]
    W = np.empty((n_off,) + tuple(node_shape) + tail, dtype=wc.dtype)
    W[...] = wc.reshape((n_off,) + (1,) * len(node_shape) + tail)
    for f, slab in enumerate(slabs):
        W[_cs_face_index(node_shape, grid_dim, f)] = slab
    return W


def _level_from_disk_cs(ent, i: int, meta, dtype) -> MGLevel:
    """Rebuild one CS-stored level: tiny disk reads, then either (big
    levels) one device program that expands the (hi, lo) pair — the hi
    part is the level's f32 operator, and the pair goes to the df ladder
    via ``dev_pairs`` — or (small levels) host numpy expansion of the hi
    part, the lo part riding along in CS form (``host_cs``) for the
    ladder."""
    grid_dim = int(meta["grid_dim"])
    vdim = int(meta["vdim"])
    node_shape = tuple(int(s) for s in meta["node_shapes"][i])
    offsets = tuple(tuple(int(x) for x in row) for row in ent[f"off{i}"])
    n_off = len(offsets)
    slabs_hi = [ent[f"csshi{i}_{f}"] for f in range(2 * grid_dim)]
    slabs_lo = [ent[f"csslo{i}_{f}"] for f in range(2 * grid_dim)]
    cs_np = (ent[f"cswchi{i}"], ent[f"cswclo{i}"], slabs_hi, slabs_lo)
    free = jnp.asarray(ent[f"free{i}"], dtype=dtype)
    dense_bytes = 4 * n_off * int(np.prod(node_shape)) * vdim * vdim

    dev_pairs = None
    if 2 * dense_bytes >= _CS_LADDER_MIN_BYTES:
        dev_pairs = _expand_cs_pair_dev(
            jnp.asarray(cs_np[0]), jnp.asarray(cs_np[1]),
            tuple(jnp.asarray(s) for s in slabs_hi),
            tuple(jnp.asarray(s) for s in slabs_lo), node_shape, grid_dim)
        w = dev_pairs[0]
    else:
        hi_grid = _expand_cs_np(cs_np[0], slabs_hi, node_shape, grid_dim)
        w = tuple(jnp.asarray(hi_grid[k], dtype=dtype) for k in range(n_off))
    omega = float(meta["omegas"][i])
    if meta["scale_kind"] == "scalar":
        s_np = ent[f"s{i}"]
        return MGLevel(offsets, w, free, omega,
                       jnp.asarray(s_np, dtype=dtype), None, None,
                       host_weights=None, host_scale=(s_np,),
                       host_pairs=None, host_cs=cs_np, dev_pairs=dev_pairs)
    C_np, Cinv_np = ent[f"C{i}"], ent[f"Cinv{i}"]
    return MGLevel(offsets, w, free, omega, None,
                   jnp.asarray(C_np, dtype=dtype),
                   jnp.asarray(Cinv_np, dtype=dtype),
                   host_weights=None, host_scale=(C_np, Cinv_np),
                   host_pairs=None, host_cs=cs_np, dev_pairs=dev_pairs)


def _level_from_disk_dense(ent, i: int, meta, dtype) -> MGLevel:
    """Rebuild one dense-stored level from its (hi, lo) f32 pair arrays."""
    hi, lo = ent[f"hi{i}"], ent[f"lo{i}"]
    n_off = hi.shape[0]
    offsets = tuple(tuple(int(x) for x in row) for row in ent[f"off{i}"])
    host_w = [hi[k].astype(np.float64) + lo[k] for k in range(n_off)]
    free = ent[f"free{i}"].astype(np.float64)
    node_shape = tuple(int(s) for s in meta["node_shapes"][i])
    vdim = int(meta["vdim"])
    if meta["scale_kind"] == "scalar":
        sysm = ScaledSystem(offsets, host_w, None, None, free, "scalar",
                            ent[f"s{i}"], None, None)
    else:
        C, Cinv = ent[f"C{i}"], ent[f"Cinv{i}"]
        sysm = ScaledSystem(offsets, host_w, None, None, free, "block",
                            None, np.swapaxes(C, -1, -2),
                            np.swapaxes(Cinv, -1, -2))
    pairs = ([hi[k] for k in range(n_off)], [lo[k] for k in range(n_off)])
    return _to_level(sysm, _ShapeOnlyMesh(node_shape), vdim, dtype,
                     omega=float(meta["omegas"][i]), pairs=pairs)


def _hierarchy_from_arrays_disk(ent, dtype) -> MGHierarchy:
    meta = ent["meta"]
    vdim = int(meta["vdim"])
    n_levels = int(meta["n_levels"])
    cs_flags = meta.get("cs") or [False] * n_levels

    def build(i):
        if cs_flags[i]:
            return _level_from_disk_cs(ent, i, meta, dtype)
        return _level_from_disk_dense(ent, i, meta, dtype)

    levels = [build(i) for i in range(n_levels)]
    if "Ainv" in ent:
        Ainv = ent["Ainv"]
        levels[-1] = levels[-1]._replace(Ainv=jnp.asarray(Ainv, dtype=dtype),
                                         host_Ainv=Ainv)
    return MGHierarchy(tuple(levels), int(meta["grid_dim"]), vdim,
                       int(meta["pre"]), int(meta["post"]),
                       int(meta["coarse_iters"]))


def load_hierarchy_from_disk(cache_key, vdim: int, dtype=jnp.float32
                             ) -> Optional[MGHierarchy]:
    """Rebuild a hierarchy purely from its disk entry (device uploads only —
    no assembly, prepare, power iterations, or df pack).  None on miss or
    unusable entry."""
    from pde_solver.utils import diskcache
    from pde_solver.utils.observability import get_logger

    ent = diskcache.load("mgh", (cache_key, vdim))
    if ent is None:
        return None
    try:
        return _hierarchy_from_arrays_disk(ent, dtype)
    except Exception as e:  # corrupt entry → caller rebuilds from scratch
        get_logger().warning("hierarchy disk entry unusable (%s)", e)
        return None


def build_hierarchy_cached(mesh: StructuredMesh, fine_system: ScaledSystem,
                           level_builder, vdim: int = 1, dtype=jnp.float32,
                           cache_key=None, **kw) -> Optional[MGHierarchy]:
    """:func:`build_hierarchy` with a disk-cache layer (f32 hierarchies only;
    ``cache_key`` = the fine system's content key, e.g. ScaledSystem.ckey)."""
    from pde_solver.utils import diskcache
    from pde_solver.utils.observability import get_logger
    import time as _time

    cacheable = (cache_key is not None and dtype == jnp.float32
                 and diskcache.enabled())
    if cacheable:
        t0 = _time.perf_counter()
        h = load_hierarchy_from_disk(cache_key, vdim, dtype)
        if h is not None:
            get_logger().info("hierarchy disk-cache hit (%.2fs rebuild)",
                              _time.perf_counter() - t0)
            return h
    h = build_hierarchy(mesh, fine_system, level_builder, vdim=vdim,
                        dtype=dtype, **kw)
    if h is not None and cacheable:
        t0 = _time.perf_counter()
        arrays, meta, all_pairs, all_cs = _hierarchy_to_arrays(h)
        # attach the freshly-split pairs/CS forms so build_df_ladder in THIS
        # process skips its own df split too
        h = h._replace(levels=tuple(
            lv._replace(host_pairs=p, host_cs=c)
            for lv, p, c in zip(h.levels, all_pairs, all_cs)))
        diskcache.store("mgh", (cache_key, vdim), arrays, meta)
        get_logger().info("hierarchy disk-cache store (%.2fs)",
                          _time.perf_counter() - t0)
    return h


# ----------------------------------------------------------------------
# V-cycle + preconditioned CG (device)
# ----------------------------------------------------------------------

def _restrict_hat(fine: MGLevel, coarse: MGLevel, r_hat: jnp.ndarray,
                  grid_dim: int, vdim: int) -> jnp.ndarray:
    """R̂ = P̂ᵀ = S_c Pᵀ S_f^{-1} (scalar) / C_c^{-1} Pᵀ C_f (block)."""
    if fine.s is not None:
        rc = restrict(r_hat / fine.s, grid_dim)
        return coarse.free * (coarse.s * rc)
    r_phys = block_matvec(fine.C, r_hat)
    rc = restrict(r_phys, grid_dim)
    out = block_matvec(coarse.Cinv, rc)
    return coarse.free * out


def _prolong_hat(fine: MGLevel, coarse: MGLevel, e_hat_c: jnp.ndarray,
                 grid_dim: int, vdim: int) -> jnp.ndarray:
    """ê_f = S_f^{-1} P S_c ê_c."""
    if fine.s is not None:
        e_phys_c = coarse.s * e_hat_c
        ef = prolong(e_phys_c, grid_dim)
        return fine.free * (ef / fine.s)
    e_phys_c = block_matvec(jnp.swapaxes(coarse.Cinv, -1, -2), e_hat_c)
    ef = prolong(e_phys_c, grid_dim)
    out = block_matvec(jnp.swapaxes(fine.C, -1, -2), ef)
    return fine.free * out


def v_cycle(h: MGHierarchy, r_hat: jnp.ndarray, level: int = 0
            ) -> jnp.ndarray:
    """One symmetric V-cycle approximating Â⁻¹ r̂ at ``level``."""
    lv = h.levels[level]
    d, vdim = h.grid_dim, h.vdim

    def A(x):
        return _stencil_apply(lv.offsets, lv.weights, x, d, vdim)

    if level == len(h.levels) - 1:
        if lv.Ainv is not None:
            # exact dense solve (keeps the V-cycle a fixed SPD operator).
            # precision=HIGHEST: a reduced-precision matmul (bf16 passes or
            # TF32) would make the coarse solve inexact → indefinite
            # preconditioner.
            flat = r_hat.reshape(-1)
            return jnp.matmul(lv.Ainv, flat,
                              precision=jax.lax.Precision.HIGHEST
                              ).reshape(r_hat.shape)
        # fallback: fixed-iteration CG (only when the dense inverse is too big)
        x = jnp.zeros_like(r_hat)
        r = r_hat
        p = r
        rz = jnp.vdot(r.reshape(-1), r.reshape(-1))

        def body(_, state):
            x, r, p, rz = state
            Ap = A(p)
            pAp = jnp.vdot(p.reshape(-1), Ap.reshape(-1))
            alpha = rz / jnp.where(pAp == 0, 1.0, pAp)
            x = x + alpha * p
            r = r - alpha * Ap
            rz_new = jnp.vdot(r.reshape(-1), r.reshape(-1))
            beta = rz_new / jnp.where(rz == 0, 1.0, rz)
            return x, r, r + beta * p, rz_new

        x, r, p, rz = jax.lax.fori_loop(0, h.coarse_iters, body, (x, r, p, rz))
        return x

    # Chebyshev polynomial smoother of degree ``pre_smooth`` on the
    # smoothing range [λmax/4, λmax] (λmax from setup power iteration;
    # lv.omega stores 4/(3 λmax) ⇒ λmax = 4/(3 ω)).  A fixed polynomial in
    # Â, hence symmetric — V-cycle stays a valid SPD preconditioner.
    lmax = 4.0 / (3.0 * lv.omega)
    lmin = lmax / 4.0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def cheb(x, rhs, degree):
        res = rhs - A(x)
        dvec = res / theta
        x = x + dvec
        rho_old = 1.0 / sigma
        for _ in range(degree - 1):
            rho = 1.0 / (2.0 * sigma - rho_old)
            dvec = (rho * rho_old * dvec
                    + (2.0 * rho / delta) * (rhs - A(x)))
            x = x + dvec
            rho_old = rho
        return x

    lvc = h.levels[level + 1]
    x = cheb(jnp.zeros_like(r_hat), r_hat, h.pre_smooth)
    rho_res = r_hat - A(x)
    rc = _restrict_hat(lv, lvc, rho_res, d, vdim)
    ec = v_cycle(h, rc, level + 1)
    x = x + _prolong_hat(lv, lvc, ec, d, vdim)
    x = cheb(x, r_hat, h.post_smooth)
    return x


def mg_pcg(h: MGHierarchy, b: jnp.ndarray, x0: jnp.ndarray, tol, maxiter,
           resync_every: int = 16):
    """Flexible PCG on the finest scaled system, one V-cycle per application.

    *Flexible* (Polak-Ribière β = z·(r−r_prev)/rz_prev) because the V-cycle
    with an iterative coarse solve is not an exactly fixed linear operator —
    textbook PCG silently loses the true residual in that setting (observed:
    recursive 5e-7 vs true 0.2 at 2M DOF).  Convergence is checked on the
    *true* residual norm ‖r‖ (always recurrence-tracked, cheap)."""
    lv = h.levels[0]
    d, vdim = h.grid_dim, h.vdim
    dtype = b.dtype
    free = lv.free

    def A(x):
        return _stencil_apply(lv.offsets, lv.weights, x, d, vdim)

    def M(r):
        z = v_cycle(h, r * free)
        return z * free + (1.0 - free) * r

    def dot(a, c):
        return jnp.vdot(a.reshape(-1), c.reshape(-1))

    one = jnp.asarray(1.0, dtype)
    x = x0
    r = b - A(x)
    bnorm2 = dot(b, b)
    bnorm2 = jnp.where(bnorm2 == 0, one, bnorm2)
    tol2 = (tol * tol) * bnorm2

    def cond(state):
        _, r, _, _, _, k = state
        return jnp.logical_and(dot(r, r) > tol2, k < maxiter)

    def body(state):
        # The preconditioner is applied at the top of the body, so the
        # V-cycle appears once in the program (not also before the loop).
        x, r, r_prev, p, rz_prev, k = state
        z = M(r)
        rz = dot(r, z)
        # Polak-Ribière: β = z·(r − r_prev)/rz_prev — robust to inexact M;
        # p starts at zero, so the first direction is z itself
        beta = (rz - dot(z, r_prev)) / jnp.where(rz_prev == 0, one, rz_prev)
        beta = jnp.maximum(beta, jnp.asarray(0.0, dtype))  # restart guard
        p = z + beta * p
        Ap = A(p)
        pAp = dot(p, Ap)
        alpha = rz / jnp.where(pAp == 0, one, pAp)
        x = x + alpha * p
        r_new = r - alpha * Ap
        if resync_every > 0:
            # periodic true-residual resync: the recurrence drifts from
            # b − A x in f32 once conjugacy degrades.  NB inside outer
            # control flow XLA lowers this cond to a select — both branches
            # execute — so short warm-started solves (transient steps) pass
            # resync_every=0 to avoid paying one wasted apply per iteration.
            r_new = jax.lax.cond(k % resync_every == resync_every - 1,
                                 lambda _: b - A(x), lambda _: r_new, None)
        return x, r_new, r, p, rz, k + 1

    zero = jnp.zeros_like(r)
    x, r, _, _, _, k = jax.lax.while_loop(
        cond, body, (x, r, zero, zero, one, jnp.asarray(0, jnp.int32)))
    relres = jnp.sqrt(dot(r, r) / bnorm2)
    return x, k, relres


def hierarchy_struct(h: MGHierarchy):
    """(static structure, array pytree) split of a hierarchy, so jitted
    programs can take the arrays as arguments (a jitted closure over large
    device arrays embeds them in the program as constants)."""
    h_struct = (tuple(lv.offsets for lv in h.levels),
                tuple(lv.omega for lv in h.levels),
                h.grid_dim, h.vdim, h.pre_smooth, h.post_smooth,
                h.coarse_iters)
    level_arrays = tuple((lv.weights, lv.free, lv.s, lv.C, lv.Cinv, lv.Ainv)
                         for lv in h.levels)
    return h_struct, level_arrays


def hierarchy_from_arrays(h_struct, level_arrays) -> MGHierarchy:
    """Inverse of :func:`hierarchy_struct` (trace-time reconstruction)."""
    (offsets_per_level, omegas, grid_dim, vdim, pre, post, coarse_iters) = h_struct
    levels = []
    for i, arrs in enumerate(level_arrays):
        weights, free, s, C, Cinv, Ainv = arrs
        levels.append(MGLevel(offsets_per_level[i], weights, free,
                              omegas[i], s, C, Cinv, Ainv))
    return MGHierarchy(tuple(levels), grid_dim, vdim, pre, post, coarse_iters)


@partial(jax.jit, static_argnames=("h_struct",))
def _jit_mg_pcg(h_struct, level_arrays, b, x0, tol, maxiter):
    """Jitted wrapper: ``h_struct`` carries the static structure, arrays come
    in as a pytree so the compile caches across solves of the same shape."""
    (offsets_per_level, omegas, grid_dim, vdim, pre, post, coarse_iters) = h_struct
    levels = []
    for i, arrs in enumerate(level_arrays):
        weights, free, s, C, Cinv = arrs
        levels.append(MGLevel(offsets_per_level[i], weights, free,
                              omegas[i], s, C, Cinv))
    h = MGHierarchy(tuple(levels), grid_dim, vdim, pre, post, coarse_iters)
    return mg_pcg(h, b, x0, tol, maxiter)


def solve_mg(h: MGHierarchy, b_hat: np.ndarray, x0_hat: Optional[np.ndarray],
             tol: float, maxiter: int):
    """Host entry: run MG-PCG on device; returns (x̂ jnp, iters, relres)."""
    h_struct = (tuple(lv.offsets for lv in h.levels),
                tuple(lv.omega for lv in h.levels),
                h.grid_dim, h.vdim, h.pre_smooth, h.post_smooth,
                h.coarse_iters)
    level_arrays = tuple(
        (lv.weights, lv.free, lv.s, lv.C, lv.Cinv) for lv in h.levels)
    dtype = h.levels[0].free.dtype
    b = jnp.asarray(b_hat, dtype=dtype)
    x0 = jnp.zeros_like(b) if x0_hat is None else jnp.asarray(x0_hat, dtype=dtype)
    return _jit_mg_pcg(h_struct, level_arrays, b, x0, tol, maxiter)


# ----------------------------------------------------------------------
# Nested iteration (full-multigrid) mixed-precision solve
# ----------------------------------------------------------------------
#
# Float32 iterative refinement alone stalls once κ_eff·ε32 ≈ 1: for a thin
# cantilever at 2M DOF the dominant (bending) component of the solution has
# such a large norm that a single-level f32 inner solve can only reduce the
# true residual by ~0.5 per round.  Nested iteration fixes this structurally:
# the Galerkin-coarse problems (Â_c = P̂ᵀÂP̂ exactly, b̂_c = P̂ᵀb̂) are solved
# first — at coarse sizes the f32 floor is harmless — and prolonged as the
# initial guess, so each level's remaining correction is O(h²)-small and
# comfortably inside f32 range.  Residuals are evaluated in float64 on the
# host (numpy / the OpenMP native kernel).

def _np_prolong(v: np.ndarray, grid_dim: int) -> np.ndarray:
    import itertools
    shape_c = v.shape[:grid_dim]
    extra = v.shape[grid_dim:]
    out = np.zeros(tuple(2 * s - 1 for s in shape_c) + extra, v.dtype)
    for pp in itertools.product((0, 1), repeat=grid_dim):
        base = tuple(slice(0, s - pi if pi else s) for s, pi in zip(shape_c, pp))
        top = tuple(slice(pi, s) for s, pi in zip(shape_c, pp))
        dst = tuple(slice(pi, None, 2) for pi in pp)
        out[dst] = v[base] if not any(pp) else 0.5 * (v[base] + v[top])
    return out


def _np_restrict(r: np.ndarray, grid_dim: int) -> np.ndarray:
    import itertools
    shape_f = r.shape[:grid_dim]
    extra = r.shape[grid_dim:]
    shape_c = tuple((s + 1) // 2 for s in shape_f)
    out = np.zeros(shape_c + extra, r.dtype)
    for pp in itertools.product((0, 1), repeat=grid_dim):
        src = tuple(slice(pi, None, 2) for pi in pp)
        rp = r[src]
        base = tuple(slice(0, s - pi if pi else s) for s, pi in zip(shape_c, pp))
        top = tuple(slice(pi, s) for s, pi in zip(shape_c, pp))
        if not any(pp):
            out[base] += rp
        else:
            out[base] += 0.5 * rp
            out[top] += 0.5 * rp
    return out


def _np_scale_mul(level: MGLevel, v: np.ndarray, kind: str) -> np.ndarray:
    """Apply a scale factor on host: kind ∈ {C, Ct, Cinv, CinvT} for block,
    {s, inv_s} for scalar."""
    hs = level.host_scale
    if len(hs) == 1:  # scalar
        s = hs[0]
        return v * s if kind in ("s",) else v / s
    C_np, Cinv_np = hs
    mats = {"C": C_np, "Ct": np.swapaxes(C_np, -1, -2),
            "Cinv": Cinv_np, "CinvT": np.swapaxes(Cinv_np, -1, -2)}[kind]
    return np.einsum("...ij,...j->...i", mats, v)


def np_restrict_hat(fine: MGLevel, coarse: MGLevel, r_hat: np.ndarray,
                    grid_dim: int) -> np.ndarray:
    free_c = np.asarray(coarse.free)
    if len(fine.host_scale) == 1:
        rc = _np_restrict(r_hat / fine.host_scale[0], grid_dim)
        return free_c * (coarse.host_scale[0] * rc)
    r_phys = _np_scale_mul(fine, r_hat, "C")
    rc = _np_restrict(r_phys, grid_dim)
    return free_c * _np_scale_mul(coarse, rc, "Cinv")


def np_prolong_hat(fine: MGLevel, coarse: MGLevel, e_hat_c: np.ndarray,
                   grid_dim: int) -> np.ndarray:
    free_f = np.asarray(fine.free)
    if len(fine.host_scale) == 1:
        ef = _np_prolong(coarse.host_scale[0] * e_hat_c, grid_dim)
        return free_f * (ef / fine.host_scale[0])
    e_phys = _np_scale_mul(coarse, e_hat_c, "CinvT")
    ef = _np_prolong(e_phys, grid_dim)
    return free_f * _np_scale_mul(fine, ef, "Ct")


def _host_apply(level: MGLevel, x: np.ndarray, grid_dim: int, vdim: int
                ) -> np.ndarray:
    """Float64 stencil apply on host (native OpenMP kernel when available)."""
    from pde_solver import native
    if native.available():
        node_shape = x.shape[:grid_dim]
        W, deltas = _host_pack(level, node_shape, vdim)
        N = int(np.prod(node_shape))
        xf = x.reshape(N, vdim) if vdim > 1 else x.reshape(N)
        y = native.stencil_apply(W, deltas, xf, vdim)
        return y.reshape(x.shape)
    from pde_solver.ops.linsolve import np_stencil_apply
    return np_stencil_apply(dict(zip(level.offsets, level.host_weights)), x,
                            grid_dim, vdim)


_HOST_PACK_CACHE: dict = {}


def _host_pack(level: MGLevel, node_shape, vdim: int):
    from pde_solver import native
    key = (id(level.host_weights), node_shape, vdim)
    if key not in _HOST_PACK_CACHE:
        _HOST_PACK_CACHE[key] = native.pack_flat_stencil(
            level.offsets, level.host_weights, node_shape, vdim)
        if len(_HOST_PACK_CACHE) > 32:
            _HOST_PACK_CACHE.pop(next(iter(_HOST_PACK_CACHE)))
    return _HOST_PACK_CACHE[key]


@partial(jax.jit, static_argnames=("grid_dim",))
def _jit_restrict_hat64(fine_scale, coarse_scale, coarse_free, r64, grid_dim):
    """f64 scaled restriction, level l → l+1 on device.

    ``*_scale`` is (s,) for scalar systems or (C, Cinv) for block systems.
    """
    if len(fine_scale) == 1:
        rc = restrict(r64 / fine_scale[0], grid_dim)
        return coarse_free * (coarse_scale[0] * rc)
    r_phys = block_matvec(fine_scale[0], r64)
    rc = restrict(r_phys, grid_dim)
    return coarse_free * block_matvec(coarse_scale[1], rc)


@partial(jax.jit, static_argnames=("grid_dim",))
def _jit_prolong_hat64(fine_scale, coarse_scale, fine_free, e64, grid_dim):
    if len(fine_scale) == 1:
        ef = prolong(coarse_scale[0] * e64, grid_dim)
        return fine_free * (ef / fine_scale[0])
    e_phys = block_matvec(jnp.swapaxes(coarse_scale[1], -1, -2), e64)
    ef = prolong(e_phys, grid_dim)
    return fine_free * block_matvec(jnp.swapaxes(fine_scale[0], -1, -2), ef)


def solve_nested(h: MGHierarchy, b_hat: np.ndarray, tol: float,
                 inner_tol: float, maxiter: int, max_rounds: int = 10):
    """Nested-iteration mixed-precision solve of the finest system
    (host-orchestrated reference path; the device-resident path is
    :func:`solve_fcycle_df2`).

    Recursive FMG with float64 bookkeeping: each level is seeded by the
    prolonged solution of the Galerkin-coarse problem, then refined by
    alternating (a) coarse pre-corrections — the low-mode residual content
    solved one level down with float64 bookkeeping, bottoming out in the
    exact f64 dense coarsest solve — and (b) float32 MG-PCG solves of the
    remaining small-norm correction.  The alternation + the f64 anchor is
    what beats the f32 accuracy floor ε32·κ(correction).

    Returns (x_hat float64 numpy, total_inner_iters, relres float).
    """
    import os as _os
    import sys as _sys
    debug = bool(_os.environ.get("PDE_MG_DEBUG"))

    def _dbg(msg):
        if debug:
            print(f"[mg] {msg}", file=_sys.stderr, flush=True)

    d, vdim = h.grid_dim, h.vdim
    n_levels = len(h.levels)
    stats = {"iters": 0}

    def f32_correct(l: int, r: np.ndarray):
        sub = MGHierarchy(h.levels[l:], d, vdim, h.pre_smooth, h.post_smooth,
                          h.coarse_iters)
        scale = float(np.max(np.abs(r)))
        if scale == 0.0 or not np.isfinite(scale):
            return np.zeros_like(r), 0.0
        d32, k, rr32 = solve_mg(sub, (r / scale).astype(np.float32), None,
                                inner_tol, maxiter)
        stats["iters"] += int(k)
        _dbg(f"f32_correct l={l} iters={int(k)} rec_relres={float(rr32):.1e}")
        return d32, scale

    def host_residual(l: int, x, b_l):
        return b_l - _host_apply(h.levels[l], x, d, vdim)

    def solve_level(l: int, b_l: np.ndarray, tol_l: float,
                    rounds: int) -> np.ndarray:
        lv = h.levels[l]
        if l == n_levels - 1:
            if lv.host_Ainv is not None:
                return (lv.host_Ainv @ b_l.reshape(-1)).reshape(b_l.shape)
            d32, scale = f32_correct(l, b_l)
            return scale * np.asarray(d32, dtype=np.float64)
        bnorm = float(np.linalg.norm(b_l.reshape(-1)))
        if bnorm == 0.0:
            return np.zeros_like(b_l)
        b_c = np_restrict_hat(lv, h.levels[l + 1], b_l, d)
        x = np_prolong_hat(lv, h.levels[l + 1],
                           solve_level(l + 1, b_c, max(tol_l, 1e-9), rounds),
                           d)
        for rnd in range(rounds):
            r = host_residual(l, x, b_l)
            relres = float(np.linalg.norm(r.reshape(-1))) / bnorm
            _dbg(f"level {l} round {rnd}: relres={relres:.2e} (target {tol_l:.1e})")
            if relres <= tol_l or not np.isfinite(relres):
                break
            r_c = np_restrict_hat(lv, h.levels[l + 1], r, d)
            x = x + np_prolong_hat(lv, h.levels[l + 1],
                                   solve_level(l + 1, r_c,
                                               max(relres * 1e-2, 1e-10), 1),
                                   d)
            r = host_residual(l, x, b_l)
            d32, scale = f32_correct(l, r)
            x = x + scale * np.asarray(d32, dtype=np.float64)
        return x

    b64_np = np.asarray(b_hat, dtype=np.float64)
    x = solve_level(0, b64_np, tol, max_rounds)
    r = b64_np - _host_apply(h.levels[0], x, d, vdim)
    relres = float(np.linalg.norm(r.reshape(-1))
                   / max(np.linalg.norm(b64_np.reshape(-1)), 1e-300))
    return x, stats["iters"], relres


# ----------------------------------------------------------------------
# Device-resident F-cycle solve
# ----------------------------------------------------------------------
#
# The recursive host-driven ladder above converges in very few inner
# iterations (~11 per f32 correction, gains ~1e-3 per round), so its cost
# is mostly dispatch and host transfers, not compute.  The F-cycle variants
# below keep every vector on device and fuse each ascend step into ONE
# jitted program per level:
#
#   descend:  r_{m+1} = R̂_m r_m                      (device)
#   coarsest: e_L = A_L^{-1} r_L                      (dense, exact)
#   ascend:   e_m = P̂ e_{m+1};  ρ = r_m − Â_m e_m;
#             e_m += s · MG-PCG_f32(levels m.., ρ/s)  (fixed iteration count)
#
# The f64-grade bookkeeping (operators, rhs, solution, defects) is carried
# in double-float32 pairs (see ops.df32), so the device programs stay in
# float32.  The only true f64 is the host dense coarsest.
#
# One F-cycle is one outer round; the host loop pulls a single scalar per
# round for the convergence check.

class DFLadder(NamedTuple):
    """Per-level double-f32 stencil pairs + f32 transfer scales (see
    ops.df32); the only f64 left is the host-side dense coarsest solve."""

    Whi: Tuple[Tuple[jnp.ndarray, ...], ...]   # per level
    Wlo: Tuple[Tuple[jnp.ndarray, ...], ...]
    bhi0: jnp.ndarray
    blo0: jnp.ndarray
    scale32: Tuple[tuple, ...]                 # per level, f32
    free32: Tuple[jnp.ndarray, ...]


# Dense-pair size above which a translation-invariant level uploads its
# constant-interior split (a few hundred scalars + thickness-2 face slabs)
# and expands to the dense (hi, lo) pair ON DEVICE: at the 2M-DOF flagship
# fine level that is ~100 MB of host→device traffic instead of ~740 MB.
# The solve programs see exactly the dense pair either way — the CS form
# never enters them.  Below the threshold the direct dense upload costs
# less than an extra compile.
_CS_LADDER_MIN_BYTES = 32 * 1024 * 1024


@partial(jax.jit, static_argnames=("node_shape", "grid_dim"))
def _expand_cs_pair_dev(wc_hi, wc_lo, slabs_hi, slabs_lo, node_shape,
                        grid_dim):
    """Device CS→dense expansion of an (hi, lo) weight pair: broadcast the
    constant interior, overwrite the exact face slabs (contiguous-slice
    scatters only), split per offset.  Bit-identical to the host expansion
    `_expand_cs_np` — pure data movement, no arithmetic."""
    def expand(wc, slabs):
        n_off = wc.shape[0]
        tail = wc.shape[1:]
        W = jnp.broadcast_to(
            wc.reshape((n_off,) + (1,) * grid_dim + tail),
            (n_off,) + tuple(node_shape) + tuple(tail))
        for f, slab in enumerate(slabs):
            W = W.at[_cs_face_index(node_shape, grid_dim, f)].set(slab)
        return tuple(W[k] for k in range(n_off))

    return expand(wc_hi, slabs_hi), expand(wc_lo, slabs_lo)


def build_df_ladder(h: MGHierarchy, sysm, b_hat: np.ndarray) -> DFLadder:
    from pde_solver.ops import df32

    Whis, Wlos, scales, frees = [], [], [], []
    for lv in h.levels:
        node_shape = tuple(int(s) for s in lv.free.shape[:h.grid_dim])
        dense_bytes = (2 * 4 * len(lv.offsets) * int(np.prod(node_shape))
                       * h.vdim * h.vdim)
        cs_np = lv.host_cs
        if cs_np is None and dense_bytes >= _CS_LADDER_MIN_BYTES \
                and lv.host_weights is not None and lv.host_pairs is None:
            cs = _cs_split_np(lv.host_weights, h.grid_dim)
            if cs is not None:
                wc64, slabs64 = cs
                cs_np = (df32.df_from_f64(wc64)
                         + tuple(zip(*(df32.df_from_f64(s)
                                       for s in slabs64))))
        if lv.dev_pairs is not None:
            # the fused CS level program already expanded the pair on device
            Whi, Wlo = lv.dev_pairs
        elif cs_np is not None and dense_bytes >= _CS_LADDER_MIN_BYTES:
            wc_hi, wc_lo, slabs_hi, slabs_lo = cs_np
            Whi, Wlo = _expand_cs_pair_dev(
                jnp.asarray(wc_hi), jnp.asarray(wc_lo),
                tuple(jnp.asarray(s) for s in slabs_hi),
                tuple(jnp.asarray(s) for s in slabs_lo),
                node_shape, h.grid_dim)
        elif lv.host_pairs is not None:
            # disk-cache path: the (hi, lo) split is already on hand
            Whi = tuple(jnp.asarray(a) for a in lv.host_pairs[0])
            Wlo = tuple(jnp.asarray(a) for a in lv.host_pairs[1])
        elif lv.host_weights is not None:
            Whi, Wlo = df32.pack_df_weights(lv.host_weights)
        else:
            # CS-only level below the threshold: host-expand the pair
            # (small arrays — the threshold keeps this cheap)
            wc_hi, wc_lo, slabs_hi, slabs_lo = cs_np
            hi = _expand_cs_np(wc_hi, slabs_hi, node_shape, h.grid_dim)
            lo = _expand_cs_np(wc_lo, slabs_lo, node_shape, h.grid_dim)
            Whi = tuple(jnp.asarray(a) for a in hi)
            Wlo = tuple(jnp.asarray(a) for a in lo)
        Whis.append(Whi)
        Wlos.append(Wlo)
        scales.append(tuple(jnp.asarray(S, dtype=jnp.float32)
                            for S in lv.host_scale))
        frees.append(lv.free)
    bhi_np, blo_np = df32.df_from_f64(np.asarray(b_hat, dtype=np.float64))
    return DFLadder(Whi=tuple(Whis), Wlo=tuple(Wlos),
                    bhi0=jnp.asarray(bhi_np), blo0=jnp.asarray(blo_np),
                    scale32=tuple(scales), free32=tuple(frees))


def ladder_with_b(ladder: DFLadder, b_hat: np.ndarray) -> DFLadder:
    """Re-target a (cached) ladder at a new RHS — the weight parts are
    operator-only, so only the two small b pair-arrays re-upload."""
    from pde_solver.ops import df32

    bhi_np, blo_np = df32.df_from_f64(np.asarray(b_hat, dtype=np.float64))
    return ladder._replace(bhi0=jnp.asarray(bhi_np),
                           blo0=jnp.asarray(blo_np))


@partial(jax.jit, static_argnames=("h_struct", "inner_iters", "n_corr"))
def _jit_ascend_df(h_struct, level_arrays, Whi_m, Wlo_m, scale_m, scale_c,
                   free_m, r_m, e_c, inner_iters, n_corr):
    """Ascend step at one level, float32-only: prolong e, then ``n_corr``
    rounds of df32-exact residual refresh + f32 MG-PCG correction."""
    from pde_solver.ops.df32 import df_stencil_residual

    (offsets_per_level, omegas, grid_dim, vdim, pre, post, coarse_iters) = h_struct
    levels = []
    for i, arrs in enumerate(level_arrays):
        weights, free, s, C, Cinv, Ainv = arrs
        levels.append(MGLevel(offsets_per_level[i], weights, free,
                              omegas[i], s, C, Cinv, Ainv))
    hh = MGHierarchy(tuple(levels), grid_dim, vdim, pre, post, coarse_iters)

    e = _jit_prolong_hat64(scale_m, scale_c, free_m, e_c, grid_dim)
    zero = jnp.zeros_like(r_m)
    iters = jnp.asarray(0, jnp.int32)
    for _ in range(n_corr):
        # exact cancellation of r_m − A e even though both are single f32:
        # TwoProd makes the products error-free
        rho, _ = df_stencil_residual(offsets_per_level[0], Whi_m, Wlo_m,
                                     r_m, zero, e, zero, grid_dim, vdim)
        scale = jnp.maximum(jnp.sqrt(jnp.vdot(rho.reshape(-1),
                                              rho.reshape(-1))), 1e-30)
        d32, k, _ = mg_pcg(hh, rho / scale, jnp.zeros_like(rho), 1e-5,
                           inner_iters)
        e = e + scale * d32
        iters = iters + k
    return e, iters


def solve_fcycle_df(h: MGHierarchy, ladder: DFLadder, tol: float,
                    inner_iters: int = 10, max_rounds: int = 10,
                    bnorm: Optional[float] = None):
    """Double-float32 F-cycle rounds; float32-only on device.

    Returns (x_hi, x_lo, iters, relres); convert with ``df32.df_to_f64``.
    ``bnorm``: see :func:`solve_fcycle_df2`."""
    from pde_solver.ops.df32 import jit_df_residual, jit_df_update

    d, vdim = h.grid_dim, h.vdim
    L = len(h.levels) - 1
    host_Ainv = h.levels[-1].host_Ainv

    def h_struct_from(m):
        return (tuple(lv.offsets for lv in h.levels[m:]),
                tuple(lv.omega for lv in h.levels[m:]),
                d, vdim, h.pre_smooth, h.post_smooth, h.coarse_iters)

    def level_arrays_from(m):
        return tuple((lv.weights, lv.free, lv.s, lv.C, lv.Cinv, lv.Ainv)
                     for lv in h.levels[m:])

    if bnorm is None:
        bnorm = float(np.sqrt(float(jnp.vdot(ladder.bhi0.reshape(-1),
                                             ladder.bhi0.reshape(-1)))))
    if bnorm == 0.0:
        z = jnp.zeros_like(ladder.bhi0)
        return z, z, 0, 0.0

    x_hi = jnp.zeros_like(ladder.bhi0)
    x_lo = jnp.zeros_like(ladder.bhi0)
    offsets0 = h.levels[0].offsets
    total = 0
    relres = 1.0
    prev = np.inf
    stalled = 0
    for rnd in range(max_rounds):
        r32, rnorm2 = jit_df_residual(offsets0, ladder.Whi[0], ladder.Wlo[0],
                                      ladder.bhi0, ladder.blo0,
                                      x_hi, x_lo, d, vdim)
        relres = float(np.sqrt(float(rnorm2))) / bnorm
        if relres <= tol or not np.isfinite(relres):
            break
        # stall detection: a round normally gains ~2 orders; two CONSECUTIVE
        # sub-2× rounds means the double-f32 floor is reached — further
        # rounds only burn time.  (Two, not one: legitimately slow-converging
        # systems — high-contrast coefficients — can have one flat round.)
        if relres > 0.5 * prev:
            stalled += 1
            if stalled >= 2:
                break
        else:
            stalled = 0
        prev = relres
        # descend (all f32 — the residual itself carries f32 information)
        rs = [r32]
        for m in range(L):
            rs.append(_jit_restrict_hat64(ladder.scale32[m],
                                          ladder.scale32[m + 1],
                                          ladder.free32[m + 1], rs[m], d))
        # coarsest: exact dense solve on host in f64 (the precision anchor)
        rL = np.asarray(rs[L], dtype=np.float64)
        e = jnp.asarray((host_Ainv @ rL.reshape(-1)).reshape(rL.shape),
                        dtype=jnp.float32)
        ks = []
        for m in range(L - 1, -1, -1):
            e, k = _jit_ascend_df(h_struct_from(m), level_arrays_from(m),
                                  ladder.Whi[m], ladder.Wlo[m],
                                  ladder.scale32[m], ladder.scale32[m + 1],
                                  ladder.free32[m], rs[m], e, inner_iters,
                                  1 if m == 0 else 2)
            ks.append(k)  # device scalar — int() here would force a sync
                          # per ascend; pull once below
        total += int(jnp.stack(ks).sum())
        x_hi, x_lo = jit_df_update(x_hi, x_lo, jnp.asarray(1.0, jnp.float32),
                                   e)
    return x_hi, x_lo, total, relres


@partial(jax.jit, static_argnames=("h_struct", "inner_iters"))
def _jit_round_df(h_struct, level_arrays, Whi, Wlo, scale32, free32,
                  Ainv32, bhi, blo, x_hi, x_lo, inner_iters):
    """One complete F-cycle round as a single float32-only program:
    df32 defect → descend → dense f32 coarsest solve (matmul) →
    df-refreshed ascends → pair update.  Returns (x_hi, x_lo, ‖r‖², iters).
    """
    from pde_solver.ops.df32 import df_stencil_residual, df_scale_add

    (offsets_per_level, omegas, grid_dim, vdim, pre, post, coarse_iters) = h_struct
    levels = []
    for i, arrs in enumerate(level_arrays):
        weights, free, s, C, Cinv, Ainv = arrs
        levels.append(MGLevel(offsets_per_level[i], weights, free,
                              omegas[i], s, C, Cinv, Ainv))
    L = len(levels) - 1

    r32, rnorm2 = df_stencil_residual(offsets_per_level[0], Whi[0], Wlo[0],
                                      bhi, blo, x_hi, x_lo, grid_dim, vdim)
    rs = [r32]
    for m in range(L):
        rs.append(_jit_restrict_hat64(scale32[m], scale32[m + 1],
                                      free32[m + 1], rs[m], grid_dim))
    # precision=HIGHEST: keep the coarsest solve in true f32 (a reduced-
    # precision matmul makes the coarse solve inexact → indefinite V-cycle).
    e = jnp.matmul(Ainv32, rs[L].reshape(-1),
                   precision=jax.lax.Precision.HIGHEST).reshape(rs[L].shape)
    iters = jnp.asarray(0, jnp.int32)
    for m in range(L - 1, -1, -1):
        e = _jit_prolong_hat64(scale32[m], scale32[m + 1], free32[m], e,
                               grid_dim)
        sub = MGHierarchy(tuple(levels[m:]), grid_dim, vdim, pre, post,
                          coarse_iters)
        zero = jnp.zeros_like(rs[m])

        def correct(_, carry, m=m, sub=sub, zero=zero):
            e, iters = carry
            rho, _ = df_stencil_residual(offsets_per_level[m], Whi[m], Wlo[m],
                                         rs[m], zero, e, zero, grid_dim, vdim)
            scale = jnp.maximum(jnp.sqrt(jnp.vdot(rho.reshape(-1),
                                                  rho.reshape(-1))), 1e-30)
            d32, k, _ = mg_pcg(sub, rho / scale, jnp.zeros_like(rho), 1e-5,
                               inner_iters)
            return e + scale * d32, iters + k

        # a loop, not an unrolled pair: the MG-PCG is traced once per level
        e, iters = jax.lax.fori_loop(0, 1 if m == 0 else 2, correct,
                                     (e, iters))
    x_hi, x_lo = df_scale_add(x_hi, x_lo, jnp.asarray(1.0, jnp.float32), e)
    return x_hi, x_lo, rnorm2, iters


def solve_fcycle_df2(h: MGHierarchy, ladder: DFLadder, tol: float,
                     inner_iters: int = 10, max_rounds: int = 12,
                     bnorm: Optional[float] = None):
    """Per-round-fused float32 F-cycle: one dispatch + one scalar pull per
    round.  Returns (x_hi, x_lo, iters, relres).

    ``inner_iters``: MG-PCG iterations per correction.  Lower values
    converge in fewer total iterations but pay the per-round fixed costs
    (residual pre-check, transfers, coarse solve, host sync) more often;
    benchmarks/df2_sweep.py sweeps it on the flagship.

    ``bnorm`` (‖b̂‖, host-computed) lets the caller avoid the entry-point
    device→host pull."""
    d, vdim = h.grid_dim, h.vdim
    h_struct = (tuple(lv.offsets for lv in h.levels),
                tuple(lv.omega for lv in h.levels),
                d, vdim, h.pre_smooth, h.post_smooth, h.coarse_iters)
    level_arrays = tuple((lv.weights, lv.free, lv.s, lv.C, lv.Cinv, lv.Ainv)
                         for lv in h.levels)
    Ainv32 = jnp.asarray(h.levels[-1].host_Ainv, dtype=jnp.float32)
    if bnorm is None:
        bnorm = float(np.sqrt(float(jnp.vdot(ladder.bhi0.reshape(-1),
                                             ladder.bhi0.reshape(-1)))))
    if bnorm == 0.0:
        z = jnp.zeros_like(ladder.bhi0)
        return z, z, 0, 0.0
    x_hi = jnp.zeros_like(ladder.bhi0)
    x_lo = jnp.zeros_like(ladder.bhi0)
    total = 0
    relres = 1.0
    prev = np.inf
    stalled = 0
    offsets0 = h.levels[0].offsets
    for rnd in range(max_rounds):
        if rnd > 0:
            # Convergence pre-check (one cheap df residual, ~2 applies):
            # checking only the fused round's internal pre-correction norm
            # would always execute one full wasted round (~1 s at 2M DOF).
            from pde_solver.ops.df32 import jit_df_residual
            _, rnorm2 = jit_df_residual(offsets0, ladder.Whi[0],
                                        ladder.Wlo[0], ladder.bhi0,
                                        ladder.blo0, x_hi, x_lo, d, vdim)
            relres = float(np.sqrt(float(rnorm2))) / bnorm
            if relres <= tol or not np.isfinite(relres):
                break
            # df32 floor: two consecutive sub-2× rounds (see solve_fcycle_df)
            if relres > 0.5 * prev:
                stalled += 1
                if stalled >= 2:
                    break
            else:
                stalled = 0
            prev = relres
        x_hi, x_lo, rnorm2, k = _jit_round_df(
            h_struct, level_arrays, ladder.Whi, ladder.Wlo, ladder.scale32,
            ladder.free32, Ainv32, ladder.bhi0, ladder.blo0, x_hi, x_lo,
            inner_iters)
        total += int(k)
    else:
        rnd = max_rounds
    if rnd == max_rounds or relres > tol:
        # final residual reflects the last executed round
        from pde_solver.ops.df32 import jit_df_residual
        _, rnorm2 = jit_df_residual(offsets0, ladder.Whi[0], ladder.Wlo[0],
                                    ladder.bhi0, ladder.blo0, x_hi, x_lo,
                                    d, vdim)
        relres = float(np.sqrt(float(rnorm2))) / bnorm
    return x_hi, x_lo, total, relres
