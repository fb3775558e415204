"""Double-float32 (double-word) pairs for near-f64 accuracy in f32 data.

The mixed-precision solvers only need f64-grade accuracy in ONE place —
evaluating the defect r = b − A x, where ~7 significant digits cancel.  The
operator, right-hand side and solution are kept as unevaluated pairs
(hi, lo) of float32 — the same bytes as one f64 copy, with device state and
every other program in f32 — and the defect is formed from the pairs in
native float64 arithmetic.

Effective precision of a pair ≈ 2^-48 ≈ 4e-15 relative — indistinguishable
from f64 for the refinement residuals.

Why float64 and not the classic all-f32 error-free transformations
(Dekker's TwoProd, Knuth's TwoSum): XLA does not evaluate them as written.
It may contract a product into the addition that consumes it (one fused
multiply-add) or keep an intermediate in higher precision, and a TwoSum fed
such a value returns a wrong error term — the pair silently degrades to
plain f32.  Float64 arithmetic is exact where the transformations needed
exactness and only gains from contraction.  The one rounding that must
happen as written, f64 → (hi, lo), splits the bits by masking, which no
conversion rewrite can elide.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pde_solver.ops.stencil import block_matvec

Offset = Tuple[int, ...]

# f64 → f32 mantissa: clearing the low 52 − 23 = 29 bits leaves a value
# that float32 represents exactly.
_HI_MASK = np.uint64(~((1 << 29) - 1) & 0xFFFFFFFFFFFFFFFF)


def df_from_f64(x64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host: split float64 into an (hi, lo) float32 pair."""
    hi = np.asarray(x64, dtype=np.float32)
    lo = np.asarray(x64 - hi.astype(np.float64), dtype=np.float32)
    return hi, lo


def df_to_f64(hi, lo) -> np.ndarray:
    return np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)


def pair_to_f64(hi, lo):
    """Device: the float64 value of an (hi, lo) pair (exact)."""
    return hi.astype(jnp.float64) + lo.astype(jnp.float64)


def split_f64(x64):
    """Device: float64 → (hi, lo) float32 pair with hi + lo = x64 to 2^-48.

    ``hi`` is x64 with its low mantissa bits cleared (exactly an f32), so
    x64 − hi is exact in f64 and only ``lo`` is rounded."""
    bits = jax.lax.bitcast_convert_type(x64, jnp.uint64)
    hi64 = jax.lax.bitcast_convert_type(bits & _HI_MASK, jnp.float64)
    return hi64.astype(jnp.float32), (x64 - hi64).astype(jnp.float32)


def df_scale_add(x_hi, x_lo, alpha, d):
    """x + alpha·d with d, alpha in f32, as a pair."""
    return split_f64(pair_to_f64(x_hi, x_lo)
                     + jnp.asarray(alpha).astype(jnp.float64)
                     * d.astype(jnp.float64))


# ----------------------------------------------------------------------
# Stencil defect from double-float32 pairs
# ----------------------------------------------------------------------

def df_stencil_residual(offsets: Tuple[Offset, ...], W_hi, W_lo,
                        b_hi, b_lo, x_hi, x_lo,
                        grid_dim: int, vdim: int):
    """r = b − A x with A, b, x in double-f32 pairs, formed in float64.

    Returns the residual as a single f32 array (once the cancellation is
    done in f64, f32 represents r to 1e-7 of its own norm, which is all the
    downstream f32 solves can use) plus ‖r‖² in f32."""
    pad = [(1, 1)] * grid_dim + [(0, 0)] * (x_hi.ndim - grid_dim)
    xp = jnp.pad(pair_to_f64(x_hi, x_lo), pad)
    shape = x_hi.shape[:grid_dim]
    y = None
    for off, Wh, Wl in zip(offsets, W_hi, W_lo):
        sl = tuple(slice(1 + o, 1 + o + n) for o, n in zip(off, shape))
        W = pair_to_f64(Wh, Wl)
        xs = xp[sl + (Ellipsis,)]
        term = W * xs if vdim == 1 else block_matvec(W, xs)
        y = term if y is None else y + term
    r = (pair_to_f64(b_hi, b_lo) - y).astype(jnp.float32)
    rnorm2 = jnp.vdot(r.reshape(-1), r.reshape(-1))
    return r, rnorm2


@partial(jax.jit, static_argnames=("offsets", "grid_dim", "vdim"))
def jit_df_residual(offsets, W_hi, W_lo, b_hi, b_lo, x_hi, x_lo,
                    grid_dim, vdim):
    return df_stencil_residual(offsets, W_hi, W_lo, b_hi, b_lo, x_hi, x_lo,
                               grid_dim, vdim)


@jax.jit
def jit_df_update(x_hi, x_lo, scale, d32):
    """x ← x + scale·d (pairwise)."""
    return df_scale_add(x_hi, x_lo, scale.astype(jnp.float32), d32)


def pack_df_weights(host_weights64) -> Tuple[Tuple[jnp.ndarray, ...],
                                             Tuple[jnp.ndarray, ...]]:
    """Split f64 host stencil weights into device (hi, lo) f32 pairs."""
    his, los = [], []
    for W in host_weights64:
        hi, lo = df_from_f64(np.asarray(W, dtype=np.float64))
        his.append(jnp.asarray(hi))
        los.append(jnp.asarray(lo))
    return tuple(his), tuple(los)
