"""Finest-level stencil apply on the accelerator: time, bytes/s, bandwidth share.

Times the XLA stencil apply (``ops.linsolve._stencil_apply``) of the scaled
flagship elasticity system and reports its bytes/s against the device-to-
device copy bandwidth measured in the same run, and against the published
peak for the detected device kind (``null`` for a kind not in the table).
Run from the repository root:

    python benchmarks/spmv_bench.py [cells_x cells_y cells_z] [--triton]

``--triton`` also times a hand-written Pallas kernel on the Triton route
(:func:`triton_stencil_apply`) against the XLA apply, at the flagship's fine
level (vdim 3) and on the 128³ heat operator (vdim 1), over a few block
sizes and warp counts.  The solver does not use the kernel: it lost this
comparison on an H100 (PERF.md).

Prints one JSON line.  Needs an accelerator: on a CPU-only machine it exits
non-zero.
"""

import argparse
import json
import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

# Published device-memory bandwidth in bytes/s, keyed by JAX's device_kind
# (NVIDIA H100 data sheet: SXM 3.35 TB/s, PCIe 2.0 TB/s, NVL 3.9 TB/s).
PEAK_MEMORY_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}

# Applies per timed program: unrolled, so no per-iteration host sync.
CHAIN = 20


def best_seconds(fn, *args, reps=5):
    """Best wall time of ``fn(*args)`` over ``reps`` calls, after one warm
    call (compile)."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def copy_bandwidth(nbytes: int = 1 << 30) -> float:
    """Device-to-device streaming bandwidth (read + write bytes per second)
    of one elementwise pass over ``nbytes`` of float32 — far larger than
    the L2 cache, so it measures device memory."""
    x = jnp.ones((nbytes // 4,), jnp.float32)
    t = best_seconds(jax.jit(lambda v: v + 1.0), x, reps=10)
    return 2 * nbytes / t


@partial(jax.jit, static_argnames=("offsets", "grid_dim", "vdim"))
def _apply_chain(offsets, weights, x, grid_dim, vdim):
    from pde_solver.ops.linsolve import _stencil_apply

    for _ in range(CHAIN):
        x = _stencil_apply(offsets, weights, x, grid_dim, vdim) * 0.1
    return x


def apply_seconds(offsets, weights, x, grid_dim, vdim):
    """Seconds per stencil apply (best of 5 chains of ``CHAIN`` applies)."""
    t = best_seconds(lambda: _apply_chain(offsets, weights, x, grid_dim,
                                          vdim))
    return t / CHAIN


def apply_bytes(weights, x) -> int:
    """Bytes one apply must move: every weight plane once, x in, y out."""
    return int(sum(w.nbytes for w in weights)) + 2 * int(x.nbytes)


def apply_report(offsets, weights, x, grid_dim, vdim, copy_bps=None):
    """Time the XLA apply; bytes/s against copy bandwidth and peak."""
    copy_bps = copy_bps or copy_bandwidth()
    sec = apply_seconds(offsets, weights, x, grid_dim, vdim)
    nbytes = apply_bytes(weights, x)
    kind = jax.devices()[0].device_kind
    peak = PEAK_MEMORY_BYTES_PER_S.get(kind)
    bps = nbytes / sec
    return {
        "apply_ms": sec * 1e3,
        "bytes": nbytes,
        "bytes_per_s": bps,
        "copy_bytes_per_s": copy_bps,
        "share_of_copy": bps / copy_bps,
        "device_kind": kind,
        "published_peak_bytes_per_s": peak,
        "share_of_peak": None if peak is None else bps / peak,
    }


def cantilever_problem(cells):
    """The flagship cantilever (1 m × 0.2 m × 0.2 m steel under gravity,
    clamped at x = 0) at ``cells``: (mesh, stencil, bc, load, builder), where
    ``builder(coarse_mesh) → (stencil, bc)`` feeds the multigrid hierarchy."""
    from pde_solver.mesh import box_mesh
    from pde_solver.models.elasticity import lame_parameters
    from pde_solver.ops import assembly
    from pde_solver.ops.bc import DirichletBC

    lam, mu = lame_parameters(210e9, 0.3, "3d")

    def clamp(m):
        return DirichletBC.from_masks([(m.face_mask(0, 0), 0.0)],
                                      m.node_shape, vdim=3)

    def builder(m):
        return assembly.assemble_elasticity_stencil(m, lam, mu), clamp(m)

    mesh = box_mesh(*cells, (0, 0, 0), (1.0, 0.2, 0.2))
    K, bc = builder(mesh)
    b = assembly.assemble_vector_load(mesh,
                                      np.array([0.0, 0.0, -9.81 * 7800.0]))
    return mesh, K, bc, b, builder


def flagship_system(cells):
    """Scaled flagship cantilever system (host arrays) at ``cells``."""
    from pde_solver.ops.linsolve import prepare_system

    mesh, K, bc, b, _ = cantilever_problem(cells)
    return prepare_system(K, mesh, bc, b, 3)


def heat_system(n):
    """Scaled unit-cube heat (stiffness) system at ``n``³ cells, u = 0 on
    the boundary."""
    from pde_solver.mesh import box_mesh
    from pde_solver.ops import assembly
    from pde_solver.ops.bc import DirichletBC, all_boundary
    from pde_solver.ops.linsolve import prepare_system

    mesh = box_mesh(n, n, n, (0, 0, 0), (1, 1, 1))
    K = assembly.assemble_scalar_stencil(mesh, "stiffness")
    bc = DirichletBC.from_masks([(all_boundary(mesh), 0.0)], mesh.node_shape)
    return prepare_system(K, mesh, bc, assembly.assemble_load(mesh), 1)


# ----------------------------------------------------------------------
# The Pallas-Triton candidate
# ----------------------------------------------------------------------
#
# Flat layout: grid node i (C order) sits at position halo + i of a
# [vdim, total] array; the halo (a whole number of blocks on each side, at
# least the largest flat offset) and the tail of the last block are zero.
# Weights are [n_offsets·vdim², total] rows in the same layout, with every
# coupling to a neighbour off the grid zeroed, so the wrap-around of a flat
# offset into the next grid row reads a zero weight.

class FlatLayout:
    def __init__(self, offsets, node_shape, block):
        strides = np.cumprod((1,) + tuple(node_shape[:0:-1]))[::-1]
        self.flat = tuple(int(np.dot(o, strides)) for o in offsets)
        self.node_shape = tuple(node_shape)
        self.n = int(np.prod(node_shape))
        self.block = block
        reach = max(abs(f) for f in self.flat)
        self.halo = -(-reach // block) * block
        self.total = 2 * self.halo + -(-self.n // block) * block

    def pack_weights(self, offsets, weights, vdim):
        rows = []
        for off, W in zip(offsets, weights):
            W = np.asarray(W, np.float32).reshape(
                self.node_shape + (vdim, vdim))
            on_grid = np.ones(self.node_shape, bool)
            for ax, (o, nk) in enumerate(zip(off, self.node_shape)):
                idx = np.arange(nk) + o
                keep = (idx >= 0) & (idx < nk)
                on_grid &= keep.reshape([-1 if a == ax else 1
                                         for a in range(len(off))])
            W = W * on_grid[..., None, None]
            rows.append(W.reshape(self.n, vdim * vdim).T)
        out = np.zeros((len(rows) * vdim * vdim, self.total), np.float32)
        out[:, self.halo:self.halo + self.n] = np.concatenate(rows)
        return jnp.asarray(out)

    def pack(self, x, vdim):
        x = jnp.asarray(x, jnp.float32).reshape(self.n, vdim).T
        return jnp.pad(x, ((0, 0), (self.halo, self.total - self.halo
                                    - self.n)))

    def unpack(self, y, vdim):
        y = y[:, self.halo:self.halo + self.n].T
        return y.reshape(self.node_shape + ((vdim,) if vdim > 1 else ()))


def triton_stencil_apply(layout, vdim, num_warps=4, scale=1.0,
                         interpret=False):
    """``apply(w, x) → scale · A x`` in the flat layout, one program per
    block of ``layout.block`` flat nodes; f32 accumulation."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    flat, block, halo = layout.flat, layout.block, layout.halo
    total = layout.total

    def kernel(w_ref, x_ref, y_ref):
        start = pl.program_id(0) * block
        inside = jnp.logical_and(start >= halo, start < total - halo)
        mask = jnp.broadcast_to(inside, (block,))
        acc = [jnp.zeros((block,), jnp.float32) for _ in range(vdim)]
        for k, f in enumerate(flat):
            xs = [plt.load(x_ref.at[c, pl.ds(start + f, block)], mask=mask,
                           other=0.0) for c in range(vdim)]
            for a in range(vdim):
                for c in range(vdim):
                    w = w_ref[(k * vdim + a) * vdim + c, pl.ds(start, block)]
                    acc[a] = acc[a] + w * xs[c]
        for a in range(vdim):
            y_ref[a, pl.ds(start, block)] = acc[a] * scale

    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((vdim, total), jnp.float32),
        grid=(total // block,), interpret=interpret,
        backend=None if interpret else "triton",
        compiler_params=None if interpret else plt.CompilerParams(
            num_warps=num_warps))


def triton_ab(label, sysm, vdim, configs=((128, 4), (256, 4), (512, 4),
                                          (512, 8), (1024, 8))):
    """Seconds per apply of the XLA apply and of the Triton candidate for
    each (block, warps); checks each candidate against the XLA result."""
    from pde_solver.ops.linsolve import _stencil_apply

    w32 = tuple(jnp.asarray(W, jnp.float32) for W in sysm.weights)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        sysm.b_hat.shape), jnp.float32)
    y_ref = jax.jit(lambda w, v: _stencil_apply(sysm.offsets, w, v, 3,
                                                vdim))(w32, x)
    out = {"case": label,
           "xla_ms": apply_seconds(sysm.offsets, w32, x, 3, vdim) * 1e3,
           "triton_ms": {}}
    shape = sysm.b_hat.shape[:3]
    for block, warps in configs:
        lay = FlatLayout(sysm.offsets, shape, block)
        wf = lay.pack_weights(sysm.offsets, sysm.weights, vdim)
        xf = lay.pack(x, vdim)
        one = jax.jit(triton_stencil_apply(lay, vdim, warps))
        err = float(jnp.abs(lay.unpack(one(wf, xf), vdim) - y_ref).max()
                    / jnp.abs(y_ref).max())
        if not err <= 1e-5:
            raise RuntimeError(f"Triton apply ({block}, {warps}) off by "
                               f"{err:.2e}")
        step = triton_stencil_apply(lay, vdim, warps, scale=0.1)

        def chain(w, v):
            for _ in range(CHAIN):
                v = step(w, v)
            return v

        sec = best_seconds(jax.jit(chain), wf, xf) / CHAIN
        out["triton_ms"][f"{block},{warps}"] = sec * 1e3
        print(f"{label}: Triton block {block} warps {warps}: "
              f"{sec * 1e3:.4f} ms (XLA {out['xla_ms']:.4f} ms), max error "
              f"{err:.2e}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cells", type=int, nargs="*", default=[160, 64, 64])
    ap.add_argument("--triton", action="store_true",
                    help="also time the Pallas-Triton candidate")
    args = ap.parse_args()
    if jax.devices()[0].platform == "cpu":
        raise SystemExit("spmv_bench measures an accelerator; JAX found none")
    cells = tuple(args.cells[:3])
    sysm = flagship_system(cells)
    w32 = tuple(jnp.asarray(W, jnp.float32) for W in sysm.weights)
    x = jnp.asarray(sysm.b_hat, jnp.float32)
    out = {"cells": list(cells), "dof": int(x.size)}
    out.update(apply_report(sysm.offsets, w32, x, 3, 3))
    if args.triton:
        out["triton_ab"] = [
            triton_ab(f"flagship {cells} fine level, vdim 3", sysm, 3),
            triton_ab("heat 128³, vdim 1", heat_system(128), 1)]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
