"""Stencil operator application — the SpMV of the framework.

The operator is y[n] = Σ_o W_o[n] * x[n + o] over a static set of node
offsets (3 in 1D, 7 in 2D, 15 in 3D for P1 on DOLFIN-compatible simplicial
grids).  Application pads ``x`` once and reads static shifted slices — a form
XLA fuses into a single bandwidth-bound pass, replacing the PETSc sparse
solve-path of the reference (fenics_mcp_server.py:311 and analogs).

Two layouts:

* scalar fields: ``x`` has shape ``[*node_shape]``, weights ``[*node_shape]``.
* vector fields (elasticity): ``x`` is ``[*node_shape, v]``, weights
  ``[*node_shape, v, v]`` and each offset contributes a small matvec.

Block products go through :func:`block_matvec`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Offset = Tuple[int, ...]


def block_matvec(W: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Per-node block product y[..., i] = Σ_j W[..., i, j] x[..., j].

    Written as elementwise multiply-adds rather than an einsum: a batched
    dot_general may run in reduced precision (TF32, bf16 passes) and each
    one is a separate op for the compiler, while this form is exact float32
    and fuses into the surrounding stencil loop."""
    y = None
    for j in range(W.shape[-1]):
        t = W[..., :, j] * x[..., None, j]
        y = t if y is None else y + t
    return y


def _padded_slice(offset: Offset, shape: Tuple[int, ...]) -> Tuple[slice, ...]:
    return tuple(slice(1 + o, 1 + o + s) for o, s in zip(offset, shape))


@dataclass(frozen=True)
class StencilOperator:
    """General (spatially varying) stencil operator.

    weights: dict offset -> jnp array [*node_shape] (scalar) or
             [*node_shape, v, v] (vector/block).
    """

    offsets: Tuple[Offset, ...]
    weights: Tuple[jnp.ndarray, ...]
    node_shape: Tuple[int, ...]
    vdim: int = 1

    @staticmethod
    def from_numpy(stencil: Dict[Offset, np.ndarray], node_shape: Tuple[int, ...],
                   dtype=jnp.float32, vdim: int = 1) -> "StencilOperator":
        offsets = tuple(sorted(stencil.keys()))
        weights = tuple(jnp.asarray(stencil[o], dtype=dtype) for o in offsets)
        return StencilOperator(offsets=offsets, weights=weights,
                               node_shape=tuple(node_shape), vdim=vdim)

    # --------------------------------------------------------------
    def apply(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x on the node grid."""
        d = len(self.node_shape)
        pad = [(1, 1)] * d + [(0, 0)] * (x.ndim - d)
        xp = jnp.pad(x, pad)
        y = None
        for off, W in zip(self.offsets, self.weights):
            sl = _padded_slice(off, self.node_shape)
            xs = xp[sl]
            if self.vdim == 1:
                term = W * xs
            else:
                term = block_matvec(W, xs)
            y = term if y is None else y + term
        return y

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.apply(x)

    # --------------------------------------------------------------
    def diagonal(self) -> jnp.ndarray:
        """Matrix diagonal (the zero-offset weight), shape [*node_shape(, v)]."""
        zero = tuple(0 for _ in self.node_shape)
        W0 = self.weights[self.offsets.index(zero)]
        if self.vdim == 1:
            return W0
        return jnp.einsum("...ii->...i", W0)

    def astype(self, dtype) -> "StencilOperator":
        return StencilOperator(
            offsets=self.offsets,
            weights=tuple(w.astype(dtype) for w in self.weights),
            node_shape=self.node_shape,
            vdim=self.vdim,
        )

    def axpy(self, alpha: float, other: "StencilOperator", beta: float = 1.0) -> "StencilOperator":
        """beta*self + alpha*other, merged over the union of offsets."""
        assert self.node_shape == other.node_shape and self.vdim == other.vdim
        merged: Dict[Offset, jnp.ndarray] = {}
        for off, W in zip(self.offsets, self.weights):
            merged[off] = beta * W
        for off, W in zip(other.offsets, other.weights):
            merged[off] = merged.get(off, 0.0) + alpha * W
        offsets = tuple(sorted(merged.keys()))
        return StencilOperator(
            offsets=offsets,
            weights=tuple(merged[o] for o in offsets),
            node_shape=self.node_shape,
            vdim=self.vdim,
        )


jax.tree_util.register_pytree_node(
    StencilOperator,
    lambda op: (op.weights, (op.offsets, op.node_shape, op.vdim)),
    lambda aux, weights: StencilOperator(offsets=aux[0], weights=tuple(weights),
                                         node_shape=aux[1], vdim=aux[2]),
)
