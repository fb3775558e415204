"""Static linear elasticity (1D bar, 2D plane stress/strain, 3D).

Capability parity with /root/reference/fenics_mcp_server.py:1470-1892:

* 1D axial bar −(EA u′)′ = f, fixed-free, outputs axial stress σ=Eε or strain,
* 2D plane stress/strain with clamped left edge and von Mises output,
* 3D box with clamped x=0 face and von Mises output (the 2M-DOF benchmark),

all as matrix-free block-stencil PCG solves.  Stress post-processing computes
the per-element tensor from constant P1 gradients (vectorized over the grid)
and L2-projects onto P1 — the exact discrete operation FEniCS' ``project``
performs at :1542-1546, :1714, :1862.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from pde_solver.config import SolverConfig, backend_policy, get_config
from pde_solver.mesh import StructuredMesh, flatten_values, interval_mesh
from pde_solver.ops import assembly
from pde_solver.ops.bc import DirichletBC
from pde_solver.ops.elements import subelem_geometry
from pde_solver.ops.linsolve import solve_stencil_system
from pde_solver.ops.projection import project_cellwise
from pde_solver.utils.observability import get_logger, phase_timer


def lame_parameters(E: float, nu: float, mode: str) -> Tuple[float, float]:
    """(λ, μ) for "plane_stress" / "plane_strain" / "3d".

    Mirrors fenics_mcp_server.py:1658-1665 (2D) and :1812-1814 (3D).
    """
    mu = E / (2.0 * (1.0 + nu))
    if mode == "plane_stress":
        lam = E * nu / (1.0 - nu ** 2)
    else:  # plane_strain and 3d share the same λ
        lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return lam, mu


def thermal_stress_coefficient(E: float, nu: float, alpha: float,
                               mode: str) -> float:
    """β such that the thermal prestress is σ_th = −β ΔT I.

    3D / plane strain: β = E α / (1 − 2ν) = (3λ+2μ) α (plane strain keeps
    the 3D relation because ε_zz = 0 leaves tr₃ε = tr₂ε); plane stress
    reduces to β = E α / (1 − ν) = (2λ_ps + 2μ) α after eliminating σ_zz.
    """
    if mode == "plane_stress":
        return E * alpha / (1.0 - nu)
    return E * alpha / (1.0 - 2.0 * nu)  # plane_strain and 3d


def _cellwise_mean(mesh: StructuredMesh, grid: np.ndarray) -> np.ndarray:
    """Per-sub-element vertex mean of a nodal field, [n_sub, *cells].

    Delegates to :func:`assembly.subelem_vertex_mean` — the SAME helper
    the thermal RHS uses, so the load-side and stress-side ΔT̄ can never
    drift apart (ADVICE r4)."""
    return assembly.subelem_vertex_mean(mesh, grid)


def _element_gradients(mesh: StructuredMesh, u_grid: np.ndarray) -> np.ndarray:
    """Per-sub-element displacement gradient, shape [n_sub, *cells, d, d].

    grad_u[i, j] = Σ_a u[node_a, i] * g_a[j]; constant per simplex for P1.
    """
    d = mesh.dim
    n_sub = len(mesh.subelems)
    out = np.zeros((n_sub,) + mesh.cell_shape + (d, d))
    for t, sub in enumerate(mesh.subelems):
        g = subelem_geometry(mesh, t, 0).grads  # [d+1, d]
        for a, delta in enumerate(sub):
            region = tuple(slice(dd, dd + n) for dd, n in zip(delta, mesh.cell_shape))
            out[t] += np.einsum("...i,j->...ij", u_grid[region], g[a])
    return out


def _vm_from_gradients(G, xp, d: int, lam: float, mu: float, iso=None):
    """von Mises (stress, strain) from per-element gradients; ``xp`` is
    numpy or jax.numpy — the formulas are shared by the host and device
    paths so they can't drift apart.

    ``iso``: optional per-element isotropic prestress magnitude β·ΔT̄
    (broadcastable to G[..., 0, 0]) subtracted from the stress diagonal —
    the thermal term σ −= β ΔT I.  Only in 3D is the subtraction
    deviator-free (von Mises unchanged — tests/test_thermal.py asserts
    it); under this code's 2×2-tensor-with-1/3·tr convention a 2D
    isotropic subtraction shifts the deviator by −(iso/3)·I₂ and DOES
    change von Mises, for plane strain and plane stress alike (the
    reference's own 2D convention, fenics_mcp_server.py:1694-1711)."""
    eps = 0.5 * (G + xp.swapaxes(G, -1, -2))
    tr = xp.trace(eps, axis1=-2, axis2=-1)
    eye = xp.eye(d, dtype=G.dtype)
    sig = lam * tr[..., None, None] * eye + 2.0 * mu * eps
    if iso is not None:
        sig = sig - xp.asarray(iso, G.dtype)[..., None, None] * eye
    eps_dev = eps - (tr / 3.0)[..., None, None] * eye
    sig_tr = xp.trace(sig, axis1=-2, axis2=-1)
    sig_dev = sig - (sig_tr / 3.0)[..., None, None] * eye
    vm_stress = xp.sqrt(1.5 * xp.sum(sig_dev * sig_dev, axis=(-2, -1)))
    vm_strain = xp.sqrt((2.0 / 3.0) * xp.sum(eps_dev * eps_dev,
                                             axis=(-2, -1)))
    return vm_stress, vm_strain


def _von_mises_device(mesh: StructuredMesh, u_grid: np.ndarray, lam: float,
                      mu: float, iso: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """f32 device evaluation of the von Mises fields: the element-gradient
    stencil is shifted slices + outer products (elementwise work, no matmul
    contraction → no reduced-precision hazard), one jitted program.  Used
    for big solves, where the host numpy path pushes GBs of temporaries
    through one core."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    d = mesh.dim
    deltas = tuple(tuple(tuple(int(x) for x in delta) for delta in sub)
                   for sub in mesh.subelems)
    grads = np.stack([subelem_geometry(mesh, t, 0).grads
                      for t in range(len(mesh.subelems))]).astype(np.float32)

    @partial(jax.jit, static_argnames=("cell_shape", "dd", "deltas"))
    def vm_prog(u, g, iso32, lam32, mu32, cell_shape, dd, deltas):
        parts = []
        for t, sub in enumerate(deltas):
            Gt = jnp.zeros(cell_shape + (dd, dd), jnp.float32)
            for a, delta in enumerate(sub):
                region = tuple(slice(x, x + n)
                               for x, n in zip(delta, cell_shape))
                Gt = Gt + u[region][..., :, None] * g[t, a][None, :]
            parts.append(Gt)
        G = jnp.stack(parts)
        return _vm_from_gradients(G, jnp, dd, lam32, mu32, iso=iso32)

    iso32 = None if iso is None else jnp.asarray(iso, jnp.float32)
    vm_s, vm_e = vm_prog(jnp.asarray(u_grid, jnp.float32),
                         jnp.asarray(grads), iso32, np.float32(lam),
                         np.float32(mu), tuple(mesh.cell_shape), d, deltas)
    return np.asarray(vm_s), np.asarray(vm_e)


# Displacement-array size above which the von Mises evaluation runs on the
# device in f32 where ``config.backend_policy`` says so (below it, or on
# CPU, the f64 host path keeps reference-grade parity).
_VM_DEVICE_MIN_SIZE = 1_000_000


def von_mises_fields(mesh: StructuredMesh, u_grid: np.ndarray, lam: float, mu: float,
                     iso: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sub-element von Mises (stress, strain) using the J2 deviator with
    a 1/3·tr convention on the d×d tensors — exactly the reference formulas
    (fenics_mcp_server.py:1694-1711, :1848-1859, including using the in-plane
    2×2 tensor with the 3D 1/3 factor in 2D).  ``iso``: optional per-element
    thermal prestress β·ΔT̄ ([n_sub, *cells] or scalar).

    Host f64 numpy by default; very large solves on an accelerator evaluate
    on device in f32 (visualization/summary-grade — relative error ~1e-7)."""
    if (u_grid.size >= _VM_DEVICE_MIN_SIZE
            and backend_policy().device_postprocess):
        return _von_mises_device(mesh, u_grid, lam, mu, iso=iso)
    d = mesh.dim
    G = _element_gradients(mesh, u_grid)               # [n_sub, *cells, d, d]
    return _vm_from_gradients(G, np, d, lam, mu, iso=iso)


# ----------------------------------------------------------------------
# Solvers
# ----------------------------------------------------------------------

def solve_bar_1d(L: float, nx: int, E: float, area: float, body_force: float,
                 quantity: str = "stress", end_load: float = 0.0,
                 alpha: float = 0.0, delta_T: float = 0.0,
                 clamp_both: bool = False,
                 config: Optional[SolverConfig] = None
                 ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """1D axial bar: −(EA u′)′ = f, u(0)=0, free at x=L.

    Returns (x coords [N], field values [N], stats).  ``quantity`` selects the
    P1-projected axial strain ε=u′ or stress σ=Eε (fenics_mcp_server.py:1541-1546).
    ``end_load``: axial point force P [N] at the free end (extension beyond
    the reference's body-force-only loading): EA u′(L) = P enters the weak
    form as + P v(L), giving the textbook σ = P/A, u = P x/(EA) exactly.
    ``alpha``/``delta_T``: uniform thermal expansion — load ∫ EAαΔT v′ dx,
    stress σ = E(ε − αΔT); with ``clamp_both`` (fixed-fixed) this yields
    the textbook constrained-bar stress σ = −EαΔT exactly, and fixed-free
    the stress-free expansion u = αΔT·x.
    """
    if clamp_both and end_load:
        # the x=L node is Dirichlet-constrained: a point load added there
        # would be silently discarded by the masking (ADVICE r4)
        raise ValueError("end_load cannot be applied with clamp_both=True: "
                         "the x=L end is displacement-constrained, so the "
                         "point load would be silently ignored")
    cfg = config or get_config()
    mesh = interval_mesh(nx, 0.0, L)
    t0 = time.perf_counter()
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    K = {o: (E * area) * W for o, W in K.items()}
    b = body_force * assembly.assemble_load(mesh, quad_degree=1)
    if end_load:
        b = b.copy()
        b[-1] += float(end_load)
    if alpha and delta_T:
        b = b + assembly.assemble_thermal_load(
            mesh, E * area * alpha, float(delta_T))[..., 0]
    clamp_masks = [(mesh.face_mask(0, 0), 0.0)]
    if clamp_both:
        clamp_masks.append((mesh.face_mask(0, 1), 0.0))
    bc = DirichletBC.from_masks(clamp_masks, mesh.node_shape)
    u, stats = solve_stencil_system(K, mesh, bc, b, config=cfg)

    # ε per element (piecewise constant), projected to P1 like FEniCS project.
    h = mesh.spacing[0]
    eps_cells = ((u[1:] - u[:-1]) / h)[None]  # [1, nx]
    if quantity == "displacement":
        # extension beyond the reference (quantity ∈ {stress, strain},
        # dispatcher_agent.py:1002-1005): the axial displacement itself,
        # already nodal — "how much does the bar stretch?"
        field = np.asarray(u, dtype=np.float64)
    elif quantity == "strain":
        field = project_cellwise(mesh, eps_cells, config=cfg)
    else:
        field_cells = E * (eps_cells - float(alpha) * float(delta_T))
        field = project_cellwise(mesh, field_cells, config=cfg)
    info = {
        "num_dofs": mesh.num_nodes,
        "cg_iterations": int(stats.iterations),
        "relative_residual": float(stats.relative_residual),
        "converged": bool(stats.converged),
        "solve_seconds": time.perf_counter() - t0,
    }
    return mesh.axis_nodes(0), field, info


def solve_elasticity_nd(mesh: StructuredMesh, E: float, nu: float,
                        body_force: np.ndarray, mode: str,
                        quantity: str = "stress",
                        traction_faces: Sequence = (),
                        thermal=None,
                        clamp_both: bool = False,
                        config: Optional[SolverConfig] = None
                        ) -> Tuple[np.ndarray, Dict]:
    """2D/3D static elasticity with the x=0 face clamped; returns the flat
    von Mises scalar field [N] plus stats.  ``mode``: plane_stress /
    plane_strain / 3d.

    ``traction_faces``: (axis, side, t_vec) surface tractions [N/m² per
    component], entering the load as the consistent P1 boundary term
    ∫_Γ t·v ds — beyond the reference, whose elasticity loads are body
    forces only (fenics_mcp_server.py:1670-1674, :1820-1824).

    ``thermal``: optional (alpha, dT) thermoelastic coupling — ``dT`` a
    nodal temperature-rise grid [*node_shape] or a uniform scalar.  Adds
    the thermal-expansion load ∫ β ΔT div(v) dx and evaluates stresses
    from σ = C:ε − β ΔT I (β per ``mode``, see
    :func:`thermal_stress_coefficient`).  ``clamp_both`` additionally
    clamps the x=L face (constrained thermal-expansion setups)."""
    cfg = config or get_config()
    d = mesh.dim
    lam, mu = lame_parameters(E, nu, mode)
    phases: Dict[str, float] = {}
    iso_cells = None
    with phase_timer(phases, "assembly"):
        K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
        b = assembly.assemble_vector_load(mesh,
                                          np.asarray(body_force, dtype=np.float64))
        for axis, side, tvec in traction_faces:
            from pde_solver.ops import surface
            bsurf = surface.assemble_face_load(mesh, int(axis), int(side))
            b = b + bsurf[..., None] * np.asarray(tvec, dtype=np.float64)
        if thermal is not None:
            alpha, dT = thermal
            beta = thermal_stress_coefficient(E, nu, float(alpha), mode)
            b = b + assembly.assemble_thermal_load(mesh, beta, dT)
            if np.isscalar(dT) or np.asarray(dT).ndim == 0:
                iso_cells = beta * float(dT)
            else:
                iso_cells = beta * _cellwise_mean(mesh, np.asarray(dT))
        clamp_masks = [(mesh.face_mask(0, 0), 0.0)]
        if clamp_both:
            clamp_masks.append((mesh.face_mask(0, 1), 0.0))
        bc = DirichletBC.from_masks(clamp_masks, mesh.node_shape, vdim=d)

    def level_builder(mesh_c):
        # re-assemble on the coarse mesh — exact Galerkin operator for
        # nested P1 spaces with homogeneous coefficients
        K_c = assembly.assemble_elasticity_stencil(mesh_c, lam, mu)
        masks_c = [(mesh_c.face_mask(0, 0), 0.0)]
        if clamp_both:
            masks_c.append((mesh_c.face_mask(0, 1), 0.0))
        bc_c = DirichletBC.from_masks(masks_c, mesh_c.node_shape, vdim=d)
        return K_c, bc_c

    with phase_timer(phases, "solve"):
        u_grid, stats = solve_stencil_system(K, mesh, bc, b, vdim=d, config=cfg,
                                             mg_level_builder=level_builder)
    with phase_timer(phases, "postprocess"):
        if quantity == "displacement":
            # extension beyond the reference (quantity ∈ {stress, strain},
            # dispatcher_agent.py:1055-1057): the displacement magnitude
            # |u| per node, kept grid-shaped for flatten_values —
            # "deflection?" answered with deflection
            field = np.linalg.norm(np.asarray(u_grid, dtype=np.float64),
                                   axis=-1)
        else:
            vm_stress, vm_strain = von_mises_fields(mesh, u_grid, lam, mu,
                                                    iso=iso_cells)
            vm = vm_strain if quantity == "strain" else vm_stress
            field = project_cellwise(mesh, vm, config=cfg)
    info = {
        "num_dofs": mesh.num_nodes * d,
        "cg_iterations": int(stats.iterations),
        "relative_residual": float(stats.relative_residual),
        "converged": bool(stats.converged),
        "convergence_target": stats.target,
        **phases,
        **(stats.phases or {}),
    }
    get_logger().info(
        "elasticity solve: %d DOF assembly=%.3fs solve=%.3fs iters=%d "
        "relres=%.2e", info["num_dofs"], phases.get("assembly_seconds", 0.0),
        phases.get("solve_seconds", 0.0), info["cg_iterations"],
        info["relative_residual"])
    return flatten_values(field, d), info


def assemble_vector_mass(mesh: StructuredMesh, rho: float) -> Dict:
    """Consistent vector mass stencil: ρ ∫ φ_n φ_m dx ⊗ I_d."""
    d = mesh.dim
    m = assembly.assemble_scalar_stencil(mesh, "mass")
    eye = np.eye(d)
    return {o: rho * W[..., None, None] * eye for o, W in m.items()}


def solve_elasticity_dynamic(mesh: StructuredMesh, E: float, nu: float,
                             rho: float, body_force: np.ndarray, mode: str,
                             dt: float, num_steps: int,
                             u0: Optional[np.ndarray] = None,
                             v0: Optional[np.ndarray] = None,
                             beta: float = 0.25, gamma: float = 0.5,
                             config: Optional[SolverConfig] = None):
    """Implicit elastodynamics ρ ü − ∇·σ(u) = f with the x=0 face clamped.

    Newmark-β time integration (β=¼, γ=½ default: unconditionally stable,
    energy-conserving).  Capability beyond the reference — its elasticity
    solvers are all static (fenics_mcp_server.py:1470-1892).  Returns a
    :class:`~pde_solver.ops.timestepping.NewmarkResult` plus stats."""
    from pde_solver.ops.timestepping import run_newmark

    cfg = config or get_config()
    d = mesh.dim
    lam, mu = lame_parameters(E, nu, mode)
    phases: Dict[str, float] = {}
    with phase_timer(phases, "assembly"):
        K = assembly.assemble_elasticity_stencil(mesh, lam, mu)
        M = assemble_vector_mass(mesh, rho)
        f = assembly.assemble_vector_load(mesh,
                                          np.asarray(body_force, np.float64))
        bc = DirichletBC.from_masks([(mesh.face_mask(0, 0), 0.0)],
                                    mesh.node_shape, vdim=d)
    shape = mesh.node_shape + (d,)
    u0 = np.zeros(shape) if u0 is None else np.asarray(u0, np.float64)
    v0 = np.zeros(shape) if v0 is None else np.asarray(v0, np.float64)

    def mg_builder(mesh_c):
        K_c = assembly.assemble_elasticity_stencil(mesh_c, lam, mu)
        M_c = assemble_vector_mass(mesh_c, rho)
        bc_c = DirichletBC.from_masks([(mesh_c.face_mask(0, 0), 0.0)],
                                      mesh_c.node_shape, vdim=d)
        return K_c, M_c, bc_c

    with phase_timer(phases, "solve"):
        res = run_newmark(K, M, mesh, bc, f, u0, v0, dt, num_steps,
                          beta=beta, gamma=gamma, vdim=d, config=cfg,
                          mg_level_builder=mg_builder)
    inner_tol = cfg.tol if cfg.resolve_precision() == "f64" \
        else cfg.transient_inner_tol
    step_target = max(inner_tol, cfg.accuracy_target)
    info = {
        "num_dofs": mesh.num_nodes * d,
        "cg_iterations": res.total_cg_iterations,
        "relative_residual": res.max_relative_residual,
        "converged": bool(res.max_relative_residual <= step_target),
        "convergence_target": step_target,
        "num_steps": num_steps,
        **phases,
    }
    get_logger().info(
        "elastodynamics: %d DOF × %d Newmark steps solve=%.3fs iters=%d",
        info["num_dofs"], num_steps, phases.get("solve_seconds", 0.0),
        res.total_cg_iterations)
    return res, info
