"""L2 projection onto P1 — consistent-mass solve.

Replicates FEniCS ``project(expr, V)`` (used by the reference for cosine/sine
initial conditions at fenics_mcp_server.py:284,:415 and for stress / von Mises
output fields at :1542-1546, :1714, :1862):  solve  M p = b,
b_i = ∫ expr φ_i dx with the consistent (not lumped) mass matrix.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from pde_solver.config import SolverConfig
from pde_solver.mesh import StructuredMesh
from pde_solver.ops import assembly
from pde_solver.ops.bc import DirichletBC
from pde_solver.ops.linsolve import solve_stencil_system


def _no_bc(mesh: StructuredMesh) -> DirichletBC:
    import jax.numpy as jnp
    shape = mesh.node_shape
    return DirichletBC(free_mask=jnp.ones(shape, jnp.float64),
                       values=jnp.zeros(shape, jnp.float64))


def project_function(mesh: StructuredMesh, fn: Callable[[np.ndarray], np.ndarray],
                     quad_degree: int = 4,
                     config: Optional[SolverConfig] = None) -> np.ndarray:
    """Project a pointwise function of coordinates onto P1 nodes."""
    M = assembly.assemble_scalar_stencil(mesh, "mass", quad_degree=2)
    b = assembly.assemble_load(mesh, source_fn=fn, quad_degree=quad_degree)
    x, _ = solve_stencil_system(M, mesh, _no_bc(mesh), b, config=config)
    return x


def project_cellwise(mesh: StructuredMesh, cell_values: np.ndarray,
                     config: Optional[SolverConfig] = None) -> np.ndarray:
    """Project a piecewise-constant (per sub-element) field onto P1.

    ``cell_values``: [n_sub, *cell_shape].  b_i = Σ_T v_T ∫_T φ_i = v_T·|T|/(d+1)
    — exact, matching FEniCS' projection of DG0-like expressions.
    """
    from pde_solver.ops.elements import subelem_geometry

    b = np.zeros(mesh.node_shape, dtype=np.float64)
    for t, sub in enumerate(mesh.subelems):
        geom = subelem_geometry(mesh, t, 1)
        share = geom.volume / (mesh.dim + 1)
        for a in range(len(sub)):
            region = tuple(slice(d, d + n) for d, n in zip(sub[a], mesh.cell_shape))
            b[region] += share * cell_values[t]
    M = assembly.assemble_scalar_stencil(mesh, "mass", quad_degree=2)
    x, _ = solve_stencil_system(M, mesh, _no_bc(mesh), b, config=config)
    return x
