"""pde_solver — a JAX PDE-solving framework for GPUs.

A ground-up JAX/XLA re-design of the capabilities of the reference
``ziyu0425/PDE-Solver`` stack (natural-language heat / linear-elasticity FEM
solving with interactive visualization).  The reference delegates all numerics
to FEniCS/DOLFIN + PETSc (C++/C); here the solve core is a structured-mesh P1
finite-element library that runs on an accelerator:

* structured simplicial meshes with closed-form connectivity
  (``pde_solver.mesh``) matching DOLFIN's Interval/Rectangle/Box meshes,
* stencil-form operators assembled by vectorized slice-adds
  (``pde_solver.ops.assembly``),
* matrix-free Jacobi-preconditioned CG with float64 iterative refinement
  (``pde_solver.ops.cg``),
* jit-compiled backward-Euler / Crank-Nicolson stepping via ``lax.scan``
  (``pde_solver.ops.timestepping``),
* geometric MG-PCG with double-float32 refinement (``pde_solver.ops.multigrid``),
* multi-device domain decomposition over ``jax.sharding.Mesh``
  (``pde_solver.parallel``).

The public tool API (``pde_solver.api``) mirrors the reference MCP tool
surface exactly (same names, signatures, defaults and result metadata) so that
the agent layer routes queries unchanged.
"""

import os as _os

import jax

# The framework uses explicit dtypes everywhere; x64 is enabled so float64
# residual/refinement passes are available (used for occasional
# high-precision steps, never the hot path).
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache.  JAX itself reads
# JAX_COMPILATION_CACHE_DIR; without it the cache lives at a fixed path in
# the checkout, since the path is part of what a later process must find.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))

__version__ = "0.1.0"

from pde_solver.config import check_environment  # noqa: E402

check_environment()


from pde_solver.schema import PDEParameters  # noqa: E402,F401
from pde_solver.fields import TimeSeriesField, SolveResult, PlotResult  # noqa: E402,F401
