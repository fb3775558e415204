"""Dirichlet boundary conditions as vectorized mask operations.

Replaces ``DirichletBC.apply`` row manipulation (fenics_mcp_server.py:296-297
and analogs) with *symmetric elimination* expressed matrix-free: constrained
DOFs are masked out of the operator input and output and re-inserted as
identity rows, which keeps the operator SPD for CG:

    Ã x = mask ⊙ A (mask ⊙ x) + (1 - mask) ⊙ x
    b̃   = mask ⊙ (b - A g) + g            (g = boundary values, 0 on free DOFs)

Boundary node sets come from structured-grid arithmetic (faces, radius tests)
instead of geometric predicates over mesh entities.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from pde_solver.mesh import StructuredMesh


@dataclass(frozen=True)
class DirichletBC:
    """free_mask: 1.0 on free DOFs, 0.0 on constrained; values: g on
    constrained DOFs (anything on free DOFs — it is masked).

    Masks are kept as *host numpy* arrays: BC data feeds host-side system
    preparation and jit-traced closures, and must never force device
    round-trips."""

    free_mask: np.ndarray  # [*node_shape] or [*node_shape, v]
    values: np.ndarray     # same shape

    @staticmethod
    def from_masks(pairs: Sequence[Tuple[np.ndarray, float]], node_shape,
                   vdim: int = 1, dtype=np.float64) -> "DirichletBC":
        """Build from (bool mask, value) pairs.  Later pairs win on overlap
        (matching DOLFIN's last-applied-BC-wins semantics for bc lists)."""
        shape = tuple(node_shape) + ((vdim,) if vdim > 1 else ())
        constrained = np.zeros(shape, dtype=bool)
        values = np.zeros(shape, dtype=np.float64)
        for mask, val in pairs:
            m = np.asarray(mask, dtype=bool)
            if vdim > 1 and m.shape == tuple(node_shape):
                m = np.repeat(m[..., None], vdim, axis=-1)
            constrained |= m
            values = np.where(m, float(val), values)
        np_dtype = np.dtype(str(jnp.dtype(dtype))) if dtype is not None else np.float64
        return DirichletBC(
            free_mask=np.asarray(~constrained, dtype=np_dtype),
            values=np.asarray(values, dtype=np_dtype),
        )

    def astype(self, dtype) -> "DirichletBC":
        np_dtype = np.dtype(str(jnp.dtype(dtype)))
        return DirichletBC(np.asarray(self.free_mask, np_dtype),
                           np.asarray(self.values, np_dtype))

    # --------------------------------------------------------------
    def constrain_operator(self, apply_A: Callable) -> Callable:
        """Wrap an operator with symmetric elimination (SPD-preserving)."""
        free = self.free_mask

        def apply(x):
            xf = x * free
            y = apply_A(xf)
            return y * free + (x - xf)

        return apply

    def constrain_rhs(self, apply_A: Callable, b: jnp.ndarray) -> jnp.ndarray:
        g = self.values * (1.0 - self.free_mask)
        return self.free_mask * (b - apply_A(g)) + g

    def apply_values(self, x: jnp.ndarray) -> jnp.ndarray:
        """Force boundary values onto a field (used for ICs, mirroring
        ``bc.apply(u_n.vector())`` at fenics_mcp_server.py:296-297)."""
        return self.free_mask * x + (1.0 - self.free_mask) * self.values


# ----------------------------------------------------------------------
# Mask builders
# ----------------------------------------------------------------------

def all_boundary(mesh: StructuredMesh) -> np.ndarray:
    return mesh.boundary_mask()

def face(mesh: StructuredMesh, axis: int, side: int) -> np.ndarray:
    return mesh.face_mask(axis, side)

def boundary_except_faces(mesh: StructuredMesh, axis: int) -> np.ndarray:
    """Boundary nodes excluding the two faces normal to ``axis`` (the
    'other faces' / 'side' predicate of solve_heat_3D,
    fenics_mcp_server.py:613-616)."""
    m = mesh.boundary_mask().copy()
    m &= ~mesh.face_mask(axis, 0)
    m &= ~mesh.face_mask(axis, 1)
    return m

def radius_shell(mesh: StructuredMesh, axes: Sequence[int], radius: float,
                 exclude_axis_faces: int = None, rtol: float = 1e-9) -> np.ndarray:
    """Boundary nodes at distance ``radius`` from the axis spanned by the
    remaining coordinate (cylinder side-wall predicate,
    fenics_mcp_server.py:590-594).  Matches the reference's ``near(r, R)``
    test on the box-fallback mesh."""
    coords = mesh.node_coords
    r = np.sqrt(sum(coords[..., a] ** 2 for a in axes))
    m = mesh.boundary_mask() & (np.abs(r - radius) <= rtol * max(abs(radius), 1.0) + 1e-12)
    if exclude_axis_faces is not None:
        m &= ~mesh.face_mask(exclude_axis_faces, 0)
        m &= ~mesh.face_mask(exclude_axis_faces, 1)
    return m
