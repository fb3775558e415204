"""P1 reference-element geometry and simplex quadrature.

Replaces the UFL/FFC form-compiler layer of the reference (symbolic weak
forms JIT-compiled to C++ element kernels, e.g.
``/root/reference/fenics_mcp_server.py:261,:304,:1677``) with hand-derived
P1 element data evaluated once at setup:

* P1 basis gradients are constant per simplex, so *any* scalar-weighted
  stiffness term separates into (reference matrix) x (quadrature average of
  the weight) — one code path covers Cartesian, cylindrical (r), spherical
  (r²) and axisymmetric-spherical (r² sinθ) forms.
* Quadrature uses Duffy-collapsed Gauss-Legendre rules on simplices, with
  point counts chosen for exactness at the requested polynomial degree, so
  polynomial forms integrate exactly (matching FEniCS bit-for-bit up to fp
  rounding) and transcendental weights (sinθ) integrate to quadrature-level
  accuracy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np

from pde_solver.mesh import StructuredMesh


@dataclass(frozen=True)
class SubElemGeometry:
    """Geometry of one sub-simplex type of a (uniform) grid cell.

    All quantities are identical for every cell because spacing is uniform.
    ``qpts`` are cell-local (relative to the cell's low corner).
    """

    grads: np.ndarray   # [d+1, d] constant physical gradients of the P1 basis
    volume: float
    qpts: np.ndarray    # [nq, d] physical quadrature points, cell-local
    qwts: np.ndarray    # [nq] physical quadrature weights (sum == volume)
    qphi: np.ndarray    # [nq, d+1] P1 basis values at the quadrature points


# ----------------------------------------------------------------------
# Quadrature on reference simplices (Duffy-collapsed Gauss-Legendre)
# ----------------------------------------------------------------------

def _gauss01(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre rule on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(max(n, 1))
    return 0.5 * (x + 1.0), 0.5 * w


@lru_cache(maxsize=None)
def simplex_quadrature(dim: int, degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """Points/weights on the unit reference simplex, exact for total degree
    ``degree`` polynomials.  Weights sum to the reference volume 1/d!."""
    degree = max(int(degree), 0)
    if dim == 1:
        x, w = _gauss01((degree + 2) // 2)
        return x[:, None], w
    if dim == 2:
        # Duffy: (u, v) -> (u, v (1 - u)); Jacobian (1 - u).
        xu, wu = _gauss01((degree + 3) // 2)
        xv, wv = _gauss01((degree + 2) // 2)
        U, V = np.meshgrid(xu, xv, indexing="ij")
        WU, WV = np.meshgrid(wu, wv, indexing="ij")
        pts = np.stack([U, V * (1.0 - U)], axis=-1).reshape(-1, 2)
        wts = (WU * WV * (1.0 - U)).reshape(-1)
        return pts, wts
    if dim == 3:
        # Double Duffy: (u,v,w) -> (u, v(1-u), w(1-u)(1-v)); J = (1-u)^2 (1-v).
        xu, wu = _gauss01((degree + 4) // 2)
        xv, wv = _gauss01((degree + 3) // 2)
        xw, ww = _gauss01((degree + 2) // 2)
        U, V, W = np.meshgrid(xu, xv, xw, indexing="ij")
        WU, WV, WW = np.meshgrid(wu, wv, ww, indexing="ij")
        x = U
        y = V * (1.0 - U)
        z = W * (1.0 - U) * (1.0 - V)
        pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
        wts = (WU * WV * WW * (1.0 - U) ** 2 * (1.0 - V)).reshape(-1)
        return pts, wts
    raise ValueError(f"Unsupported dim {dim}")


# ----------------------------------------------------------------------
# Sub-element geometry
# ----------------------------------------------------------------------

@lru_cache(maxsize=None)
def _subelem_geometry_cached(spacing: Tuple[float, ...], subelem: Tuple[Tuple[int, ...], ...],
                             degree: int) -> SubElemGeometry:
    d = len(spacing)
    verts = np.array(subelem, dtype=np.float64) * np.array(spacing)  # [d+1, d]
    J = (verts[1:] - verts[0]).T  # [d, d], columns = edge vectors
    detJ = np.linalg.det(J)
    volume = abs(detJ) / math.factorial(d)

    # P1 gradients: reference-basis grads pulled back through J^{-T}.
    ref_grads = np.vstack([-np.ones((1, d)), np.eye(d)])  # [d+1, d]
    grads = ref_grads @ np.linalg.inv(J)  # [d+1, d]

    ref_pts, ref_wts = simplex_quadrature(d, degree)
    qpts = verts[0] + ref_pts @ J.T            # [nq, d] cell-local physical
    qwts = ref_wts * abs(detJ)                 # sums to volume
    qphi = np.hstack([1.0 - ref_pts.sum(axis=1, keepdims=True), ref_pts])  # [nq, d+1]
    return SubElemGeometry(grads=grads, volume=float(volume), qpts=qpts, qwts=qwts, qphi=qphi)


def subelem_geometry(mesh: StructuredMesh, t: int, degree: int = 2) -> SubElemGeometry:
    """Geometry of sub-simplex type ``t`` at the requested quadrature degree."""
    return _subelem_geometry_cached(mesh.spacing, mesh.subelems[t], int(degree))


# ----------------------------------------------------------------------
# Elasticity element matrices (isotropic, constant per element)
# ----------------------------------------------------------------------

def elasticity_element_matrix(geom: SubElemGeometry, lam: float, mu: float) -> np.ndarray:
    """K[a, i, b, j] = ∫ σ(φ_b e_j) : ε(φ_a e_i) over the simplex.

    σ(u) = λ tr(ε) I + 2 μ ε,  ε(u) = sym(grad u)  — the isotropic form used
    by the reference elasticity solvers (fenics_mcp_server.py:1658-1677,
    :1812-1827).  With P1 elements the integrand is constant, so the integral
    is the pointwise bilinear form times the volume.
    """
    g = geom.grads  # [n_a, d]
    d = g.shape[1]
    # ε(φ_b e_j)_kl = 0.5 (g_b[k] δ_lj + g_b[l] δ_kj)
    eye = np.eye(d)
    eps = 0.5 * (np.einsum("bk,lj->bjkl", g, eye) + np.einsum("bl,kj->bjkl", g, eye))
    tr_eps = np.einsum("bjkk->bj", eps)
    sig = lam * np.einsum("bj,kl->bjkl", tr_eps, eye) + 2.0 * mu * eps
    K = np.einsum("bjkl,aikl->aibj", sig, eps) * geom.volume
    return K  # [n_a, d, n_b, d]
