"""Independent textbook FEM implementation used as a golden reference.

This module deliberately shares no code with ``pde_solver``: it builds
explicit vertex/cell tables and assembles scipy sparse matrices with a
per-element Python loop — the classic formulation (and the same
discretization DOLFIN uses), so agreement with the vectorized stencil
assembly validates both the math and the DOLFIN-compatible mesh topology.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import scipy.sparse as sp


def build_simplices(n_cells, origin, extent):
    """Vertex coords [N, d] and simplex connectivity [ncell, d+1] matching
    DOLFIN Interval/Rectangle('right')/Box meshes (lexicographic nodes,
    x fastest)."""
    d = len(n_cells)
    shape = tuple(n + 1 for n in n_cells)
    spacing = [e / n for e, n in zip(extent, n_cells)]

    def nid(idx):
        # x fastest
        out = 0
        for a in reversed(range(d)):
            out = out * shape[a] + idx[a]
        return out

    verts = np.zeros((int(np.prod(shape)), d))
    for idx in itertools.product(*[range(s) for s in shape]):
        verts[nid(idx)] = [origin[a] + spacing[a] * idx[a] for a in range(d)]

    if d == 1:
        local = [((0,), (1,))]
    elif d == 2:
        local = [((0, 0), (1, 0), (1, 1)), ((0, 0), (1, 1), (0, 1))]
    else:
        local = [
            ((0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)),
            ((0, 0, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)),
            ((0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1)),
            ((0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)),
            ((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)),
            ((0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1)),
        ]
    cells = []
    for cidx in itertools.product(*[range(n) for n in n_cells]):
        for sub in local:
            cells.append([nid(tuple(c + o for c, o in zip(cidx, off))) for off in sub])
    return verts, np.array(cells, dtype=np.int64)


def _simplex_quad(d, degree):
    """Tiny simplex quadrature for the reference path (Grundmann-Moeller-free:
    just use a dense Duffy-independent rule — midpoint-ish rules exact enough
    for the polynomial degrees exercised by tests)."""
    # Use numpy Gauss-Legendre collapsed rules, independent derivation.
    import numpy.polynomial.legendre as leg

    def g01(n):
        x, w = leg.leggauss(max(n, 1))
        return (x + 1) / 2, w / 2

    if d == 1:
        x, w = g01(degree + 1)
        return x[:, None], w
    if d == 2:
        xu, wu = g01(degree + 2)
        xv, wv = g01(degree + 2)
        pts, wts = [], []
        for u, a in zip(xu, wu):
            for v, b in zip(xv, wv):
                pts.append([u, v * (1 - u)])
                wts.append(a * b * (1 - u))
        return np.array(pts), np.array(wts)
    xu, wu = g01(degree + 3)
    xv, wv = g01(degree + 3)
    xw, ww = g01(degree + 3)
    pts, wts = [], []
    for u, a in zip(xu, wu):
        for v, b in zip(xv, wv):
            for w_, c in zip(xw, ww):
                pts.append([u, v * (1 - u), w_ * (1 - u) * (1 - v)])
                wts.append(a * b * c * (1 - u) ** 2 * (1 - v))
    return np.array(pts), np.array(wts)


def assemble(verts, cells, term="stiffness", weight=None, cell_coeff=None, degree=4):
    """Assemble scalar stiffness/mass sparse matrix with a per-element loop."""
    N = len(verts)
    d = verts.shape[1]
    rows, cols, vals = [], [], []
    ref_pts, ref_wts = _simplex_quad(d, degree)
    for e, cell in enumerate(cells):
        X = verts[cell]  # [d+1, d]
        J = (X[1:] - X[0]).T
        detJ = np.linalg.det(J)
        grads = np.vstack([-np.ones((1, d)), np.eye(d)]) @ np.linalg.inv(J)
        qp = X[0] + ref_pts @ J.T
        qw = ref_wts * abs(detJ)
        w = np.ones(len(qw)) if weight is None else np.asarray(weight(qp), dtype=float)
        c = 1.0 if cell_coeff is None else cell_coeff[e]
        phi = np.hstack([1 - ref_pts.sum(1, keepdims=True), ref_pts])
        for a in range(d + 1):
            for b in range(d + 1):
                if term == "stiffness":
                    v = grads[a] @ grads[b] * np.sum(qw * w)
                else:
                    v = np.sum(qw * w * phi[:, a] * phi[:, b])
                rows.append(cell[a]); cols.append(cell[b]); vals.append(c * v)
    return sp.coo_matrix((vals, (rows, cols)), shape=(N, N)).tocsr()


def assemble_load(verts, cells, f=None, weight=None, degree=4):
    N = len(verts)
    d = verts.shape[1]
    b = np.zeros(N)
    ref_pts, ref_wts = _simplex_quad(d, degree)
    for cell in cells:
        X = verts[cell]
        J = (X[1:] - X[0]).T
        detJ = np.linalg.det(J)
        qp = X[0] + ref_pts @ J.T
        qw = ref_wts * abs(detJ)
        fv = np.ones(len(qw)) if f is None else np.asarray(f(qp), dtype=float)
        wv = np.ones(len(qw)) if weight is None else np.asarray(weight(qp), dtype=float)
        phi = np.hstack([1 - ref_pts.sum(1, keepdims=True), ref_pts])
        for a in range(d + 1):
            b[cell[a]] += np.sum(qw * fv * wv * phi[:, a])
    return b


def _elasticity_element(X, lam, mu):
    """Element stiffness [(d+1)·d, (d+1)·d] of one simplex with vertices X,
    local dof = vertex*d + component."""
    d = X.shape[1]
    eye = np.eye(d)
    J = (X[1:] - X[0]).T
    detJ = np.linalg.det(J)
    vol = abs(detJ) / math.factorial(d)
    grads = np.vstack([-np.ones((1, d)), np.eye(d)]) @ np.linalg.inv(J)
    Ke = np.zeros(((d + 1) * d, (d + 1) * d))
    for a in range(d + 1):
        for b_ in range(d + 1):
            for i in range(d):
                for j in range(d):
                    # eps(phi_b e_j) : sigma(phi_a e_i)
                    eps_b = 0.5 * (np.outer(grads[b_], eye[j]) + np.outer(eye[j], grads[b_]))
                    eps_a = 0.5 * (np.outer(grads[a], eye[i]) + np.outer(eye[i], grads[a]))
                    sig_b = lam * np.trace(eps_b) * eye + 2 * mu * eps_b
                    Ke[a * d + i, b_ * d + j] = np.sum(sig_b * eps_a) * vol
    return Ke


def assemble_elasticity(verts, cells, lam, mu):
    """Vector P1 elasticity stiffness, dofs blocked per node: dof = node*d + i.

    Element matrices depend only on the element's edge vectors, so congruent
    elements (all translates on a structured mesh) share one computation."""
    N = len(verts)
    d = verts.shape[1]
    n_loc = (d + 1) * d
    rows, cols, vals = [], [], []
    elem_cache = {}
    for cell in cells:
        X = verts[cell]
        key = (X[1:] - X[0]).tobytes()
        Ke = elem_cache.get(key)
        if Ke is None:
            Ke = elem_cache[key] = _elasticity_element(X, lam, mu)
        dofs = (cell[:, None] * d + np.arange(d)).ravel()
        rows.append(np.repeat(dofs, n_loc))
        cols.append(np.tile(dofs, n_loc))
        vals.append(Ke.ravel())
    return sp.coo_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(N * d, N * d)).tocsr()
