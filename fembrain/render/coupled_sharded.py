"""The north-star step as ONE multi-device SPMD program:

    force -> sharded FEM solve (halo exchange over the mesh axis)
          -> RBF displacement weights (replicated [M+4, 3] matmul)
          -> deformed trace (rays sharded over the same axis)

All inside a single jax.jit: the FEM stage shards the mesh over the
device axis (per-CG-iteration communication is a halo ppermute, which XLA
hands to NCCL over NVLink), the glue gathers the M center-node
displacement rows (~KBs; XLA inserts the collective), the weights solve
is replicated (the [M+4, M+4] factor is tiny), and the trace stage shards
RAYS over the same devices (render.pallas_trace.trace_pallas_sharded —
tiles are independent, no collectives). FEM and rendering scale on the
same cards (BASELINE: four H100s).

Matches the per-frame coupling of the reference
(src/implicit/OclPolygonizer.cpp:1543-1596), distributed; semantics equal
the single-device coupled steps (tested).
"""
from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..blob.scene import Scene
from ..fem.partitioned import (
    NODE_AXIS,
    PartFemMesh,
    build_partitioned,
    partitioned_timestep,
    to_partition_order,
)
from .deformed import (
    DispInterp,
    FIXED_POINT_ITERS,
    _implicit_hit_correction,
    build_disp_interp,
    disp_weights_centers,
    frame_max_disp,
    trace_deformed_rbf,
    wendland_pallas_spec,
)
from .pallas_trace import (
    select_trace_path,
    trace_pallas_image_sharded,
    trace_pallas_sharded,
)
from .sphere_trace import TraceParams


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CoupledSharded:
    """Static setup for the sharded coupled step on one FEM mesh."""
    pm: PartFemMesh
    interp: DispInterp
    center_slot: jax.Array  # [M] partition-order row of each RBF center


def build_coupled_sharded(nodes, tets, n_parts: int,
                          fixed=None, n_centers: int | None = None,
                          kernel: str = "biharmonic",
                          **material) -> CoupledSharded:
    """Partition the mesh and map the RBF centers into partition order
    (host-side, once per mesh topology). `kernel` is the displacement
    interpolant's kind (render.deformed.build_disp_interp)."""
    pm = build_partitioned(nodes, tets, n_parts, fixed=fixed, **material)
    fixed_idx = None if fixed is None else np.asarray(fixed)
    interp = build_disp_interp(nodes, n_centers=n_centers, fixed=fixed_idx,
                               kernel=kernel)
    perm = np.asarray(pm.perm)           # partition slot -> original id
    slot_of = np.empty(pm.n_nodes, np.int64)
    slot_of[perm] = np.arange(pm.n_nodes)
    center_slot = slot_of[np.asarray(interp.center_nodes)]
    return CoupledSharded(
        pm=pm,
        interp=interp,
        center_slot=jnp.asarray(center_slot, jnp.int32),
    )


def disp_weights_from_partition(cs: CoupledSharded, q_p: jax.Array):
    """RBF weights from the partition-layout state [D, Nl, 3]: gather the
    M center rows (XLA inserts the cross-shard collective — M is ~1e2, so
    this is KBs) and apply the replicated factored solve."""
    u_c = q_p.reshape(-1, 3)[cs.center_slot]          # [M, 3]
    return disp_weights_centers(cs.interp, u_c)       # [M+4, 3]


def _sharded_deformed_trace(scene, interp, w, device_mesh, axis, ro, rd,
                            params, image_hw, use_pallas, interpret,
                            differentiable, max_disp, fp_iters, k_refresh):
    """The trace stage of the sharded coupled steps, on the path
    render.pallas_trace.select_trace_path picks (use_pallas / interpret as
    in render.deformed.trace_deformed_rbf_fast). On the kernel path rays
    shard over `axis`; the forward-only kernel's roots get the
    implicit-hit correction against the XLA deformed field, so gradients
    match the single-device step. The XLA path traces the replicated
    field under the same jit (XLA shards it by the rays' layout)."""
    path = select_trace_path(scene, deformed=interp.kind, interpret=interpret)
    if use_pallas and not path.kernel:
        raise ValueError(f"trace kernel unavailable: {path.reason}")
    max_disp = frame_max_disp(interp, w, max_disp)
    if use_pallas is False or not path.kernel:
        return trace_deformed_rbf(scene, interp, w, ro, rd, params,
                                  max_disp=max_disp, fp_iters=fp_iters)
    disp = wendland_pallas_spec(interp, jax.lax.stop_gradient(w), max_disp, 1,
                                k_refresh=k_refresh)
    if image_hw is not None:
        t, hit = trace_pallas_image_sharded(
            scene, ro, rd, image_hw[0], image_hw[1], device_mesh,
            axis=axis, params=params, interpret=path.interpret, disp=disp,
        )
    else:
        t, hit = trace_pallas_sharded(
            scene, ro, rd, device_mesh, axis=axis, params=params,
            interpret=path.interpret, disp=disp,
        )
    if differentiable:
        t = _implicit_hit_correction(scene, interp, w, ro, rd, t, hit, params,
                                     max_disp, fp_iters)
    return t, hit


def coupled_step_sharded(scene: Scene, cs: CoupledSharded,
                         device_mesh: Mesh,
                         q_p: jax.Array, qvel_p: jax.Array, dv_p: jax.Array,
                         f_ext_p: jax.Array,
                         ro: jax.Array, rd: jax.Array,
                         h: float = 0.0333,
                         params: TraceParams = TraceParams(),
                         image_hw: tuple[int, int] | None = None,
                         max_disp: float | None = None,
                         fp_iters: int = FIXED_POINT_ITERS,
                         cg_tol: float | None = None,
                         differentiable: bool = False,
                         use_pallas: bool | None = None,
                         interpret: bool = False,
                         k_refresh: int = 0):
    """One sharded coupled frame. State arrays live in partition layout
    [D, Nl, 3] (fem.partitioned.to_partition_order); rays are global and
    shard internally. Returns (t, hit, (q', qvel', dv'), cg_iters).

    device_mesh must be 1-D with axis NODE_AXIS ('nodes') — the same
    devices carry node shards in the FEM stage and ray shards in the
    trace stage. differentiable=True routes both stages' implicit
    differentiation (custom_linear_solve FEM adjoint + hit implicit diff)
    so image losses reach material/primitive parameters across shards.
    The trace path: see _sharded_deformed_trace."""
    kw = {} if cg_tol is None else {"cg_tol": cg_tol}
    q2, v2, dv2, iters = partitioned_timestep(
        cs.pm, device_mesh, q_p, qvel_p, f_ext_p, h=h, dv=dv_p,
        differentiable=differentiable, **kw,
    )
    w = disp_weights_from_partition(cs, q2)
    t, hit = _sharded_deformed_trace(
        scene, cs.interp, w, device_mesh, NODE_AXIS, ro, rd, params,
        image_hw, use_pallas, interpret, differentiable, max_disp, fp_iters,
        k_refresh,
    )
    return t, hit, (q2, v2, dv2), iters


# --------------------------------------------------------------------------
# GRID-FEM sharded coupled step: the PRODUCTION composition. The version
# above composes the unstructured partitioned solver; this one runs the
# X-slab sharded GRID solver (fem.grid_sharded — stencil matvec,
# plane-halo ppermutes, multigrid preconditioner, far fewer CG iterations)
# under the same single jit as the sharded deformed trace.
# --------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CoupledGridSharded:
    """Static setup for the grid-backed sharded coupled step."""
    sgf: object              # fem.grid_sharded.ShardedGridFem
    interp: DispInterp
    center_flat: jax.Array   # [M] index of each RBF center's grid vertex
                             #   in the flattened [D*Xl, Y, Z] shard layout


def build_coupled_grid_sharded(grid, tm, n_parts: int, fixed_nodes=None,
                               n_centers: int | None = None,
                               kernel: str = "wendland",
                               interp: DispInterp | None = None,
                               **material) -> CoupledGridSharded:
    """Host-side: build the X-slab sharded grid FEM plus the displacement
    interpolant (or take `interp`, built on tm's nodes, such as the one a
    single-device step already uses), and map the RBF centers into the
    shard layout."""
    from ..fem import grid_fem as gfm
    from ..fem import grid_sharded as gsh

    sgf = gsh.build_sharded_grid_fem(
        grid, tm, n_parts, fixed_nodes=fixed_nodes, **material
    )
    if interp is None:
        interp = build_disp_interp(
            np.asarray(tm.nodes)[: int(tm.n_nodes)], n_centers=n_centers,
            fixed=fixed_nodes, kernel=kernel,
        )
    n2g = gfm.node_to_grid_index(tm)
    g = n2g[np.asarray(interp.center_nodes)]
    X, Y, Z = sgf.dims
    gx, gy, gz = g // (Y * Z), (g // Z) % Y, g % Z
    flat = (gx * Y + gy) * Z + gz  # == global flat == shard-layout flat
    # (the shard layout [D, Xl, Y, Z] flattens to [D*Xl, Y, Z] with
    # D*Xl >= X padded planes appended — global x-plane order preserved).
    return CoupledGridSharded(
        sgf=sgf, interp=interp,
        center_flat=jnp.asarray(flat, jnp.int32),
    )


def scale_grid_E(sgf, e_scale):
    """Scale the sharded grid FEM's Young's modulus (element stiffness is
    linear in E for fixed nu). Only the solve operator (local.ke) is
    scaled; the multigrid preconditioner stays at E=1 — that changes CG
    convergence slightly, never the solution (custom_linear_solve's
    adjoint likewise only needs the matvec to be correct)."""
    return dataclasses.replace(
        sgf,
        local=dataclasses.replace(sgf.local, ke=sgf.local.ke * e_scale),
    )


def coupled_step_grid_sharded(scene: Scene, cgs: CoupledGridSharded,
                              device_mesh: Mesh,
                              q, qvel, dv, f_ext,
                              ro: jax.Array, rd: jax.Array,
                              h: float = 0.0333,
                              E_scale=None,
                              params: TraceParams = TraceParams(),
                              image_hw: tuple[int, int] | None = None,
                              cg_tol: float | None = None,
                              differentiable: bool = False,
                              use_pallas: bool | None = None,
                              interpret: bool = False,
                              max_disp=None,
                              fp_iters: int = FIXED_POINT_ITERS,
                              k_refresh: int = 0):
    """One grid-backed sharded coupled frame: X-slab grid FEM solve ->
    replicated RBF weights (M-row cross-shard gather, ~KBs) -> deformed
    Pallas trace with rays sharded over the SAME devices, in one jitted
    SPMD program. State arrays live in shard layout [D, Xl, Y, Z, 3]
    (fem.grid_sharded.to_shard_layout). Returns
    (t, hit, (q', qvel', dv'), cg_iters).

    differentiable=True routes custom_linear_solve + implicit hit
    differentiation, so d(image loss)/d(E_scale) works across shards
    (matches the single-device coupled_step_grid_fast semantics)."""
    from ..fem import grid_sharded as gsh

    sgf = cgs.sgf if E_scale is None else scale_grid_E(cgs.sgf, E_scale)
    kw = {} if cg_tol is None else {"cg_tol": cg_tol}
    q2, v2, dv2, iters = gsh.sharded_timestep(
        sgf, device_mesh, q, qvel, f_ext, h=h, dv=dv,
        differentiable=differentiable, **kw,
    )
    u_c = q2.reshape(-1, 3)[cgs.center_flat]          # [M, 3] tiny gather
    w = disp_weights_centers(cgs.interp, u_c)
    t, hit = _sharded_deformed_trace(
        scene, cgs.interp, w, device_mesh, gsh.GRID_AXIS, ro, rd, params,
        image_hw, use_pallas, interpret, differentiable, max_disp, fp_iters,
        k_refresh,
    )
    return t, hit, (q2, v2, dv2), iters
