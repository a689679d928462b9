"""Multi-chip FEM: tetrahedra sharded across the device mesh.

The distributed analog the reference never had (SURVEY §2.6 P7): element
work (corotational force/stiffness products — the FLOPs) is sharded along
a `tets` mesh axis with `shard_map`; nodal state (q, qdot — small) is
replicated, and per-shard partial nodal assemblies are combined with a
single `psum` — a deterministic segment-sum + all-reduce instead of the
halo bookkeeping a partitioned-node scheme would need (node state for even
1M tets is ~ a few MB, far below HBM; the reduction rides ICI).

The CG loop runs replicated with the sharded matvec inside, so the whole
implicit solve is one jitted SPMD program.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from . import corotational as co
from . import integrator as integ
from .integrator import FemState
from .tetmesh import FemMesh

TET_AXIS = "tets"


def make_tet_mesh_axis(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (TET_AXIS,))


def pad_mesh_for_sharding(mesh: FemMesh, n_shards: int) -> FemMesh:
    """Pad element arrays so the tet count divides the mesh axis; padding
    tets are degenerate no-ops (zero stiffness/volume, node 0 corners)."""
    t = mesh.n_tets
    rem = (-t) % n_shards
    if rem == 0:
        return mesh
    pad_tets = jnp.zeros((rem, 4), mesh.tets.dtype)
    return dataclasses.replace(
        mesh,
        tets=jnp.concatenate([mesh.tets, pad_tets]),
        inv_dm=jnp.concatenate(
            [mesh.inv_dm, jnp.tile(jnp.eye(3, dtype=mesh.inv_dm.dtype),
                                   (rem, 1, 1))]
        ),
        volume=jnp.concatenate([mesh.volume, jnp.zeros(rem, mesh.volume.dtype)]),
        ke=jnp.concatenate(
            [mesh.ke, jnp.zeros((rem, 12, 12), mesh.ke.dtype)]
        ),
        n_tets=t + rem,
    )


def _element_spec(mesh_axes: Mesh):
    return NamedSharding(mesh_axes, P(TET_AXIS))


def place_sharded(mesh: FemMesh, device_mesh: Mesh) -> FemMesh:
    """Put element arrays tet-sharded and nodal arrays replicated."""
    elem = NamedSharding(device_mesh, P(TET_AXIS))
    repl = NamedSharding(device_mesh, P())
    return dataclasses.replace(
        mesh,
        tets=jax.device_put(mesh.tets, elem),
        inv_dm=jax.device_put(mesh.inv_dm, elem),
        volume=jax.device_put(mesh.volume, elem),
        ke=jax.device_put(mesh.ke, elem),
        rest=jax.device_put(mesh.rest, repl),
        mass=jax.device_put(mesh.mass, repl),
        fixed=jax.device_put(mesh.fixed, repl),
    )


def _shard_fns(mesh: FemMesh, device_mesh: Mesh):
    """shard_map'ed element kinematics / force / matvec closures."""
    n_nodes = mesh.n_nodes
    elem_in = (P(TET_AXIS),) * 4  # tets, inv_dm, volume, ke
    repl = P()

    def local_mesh(tets, inv_dm, volume, ke, rest, mass, fixed):
        # node_gather indexes the GLOBAL slot space; shard-local slot
        # arrays need index-add assembly (corotational._scatter_nodes).
        return dataclasses.replace(
            mesh, tets=tets, inv_dm=inv_dm, volume=volume, ke=ke,
            rest=rest, mass=mass, fixed=fixed, node_gather=None,
            n_tets=tets.shape[0], n_nodes=n_nodes,
        )

    @partial(
        shard_map,
        mesh=device_mesh,
        in_specs=elem_in + (repl, repl, repl, repl),
        out_specs=P(TET_AXIS),
    )
    def rotations(tets, inv_dm, volume, ke, rest, mass, fixed, u):
        lm = local_mesh(tets, inv_dm, volume, ke, rest, mass, fixed)
        _, R = co.element_kinematics(lm, u)
        return R

    @partial(
        shard_map,
        mesh=device_mesh,
        in_specs=elem_in + (repl, repl, repl, P(TET_AXIS), repl),
        out_specs=repl,
    )
    def forces(tets, inv_dm, volume, ke, rest, mass, fixed, R, u):
        lm = local_mesh(tets, inv_dm, volume, ke, rest, mass, fixed)
        f_local = co.internal_forces(lm, u, R)
        return jax.lax.psum(f_local, TET_AXIS)

    @partial(
        shard_map,
        mesh=device_mesh,
        in_specs=elem_in + (repl, repl, repl, P(TET_AXIS), repl),
        out_specs=repl,
    )
    def k_apply(tets, inv_dm, volume, ke, rest, mass, fixed, R, v):
        lm = local_mesh(tets, inv_dm, volume, ke, rest, mass, fixed)
        return jax.lax.psum(co.stiffness_apply(lm, R, v), TET_AXIS)

    @partial(
        shard_map,
        mesh=device_mesh,
        in_specs=elem_in + (repl, repl, repl, P(TET_AXIS)),
        out_specs=repl,
    )
    def k_diag(tets, inv_dm, volume, ke, rest, mass, fixed, R):
        lm = local_mesh(tets, inv_dm, volume, ke, rest, mass, fixed)
        return jax.lax.psum(co.stiffness_diag(lm, R), TET_AXIS)

    elem_args = (mesh.tets, mesh.inv_dm, mesh.volume, mesh.ke,
                 mesh.rest, mesh.mass, mesh.fixed)
    return (
        lambda u: rotations(*elem_args, u),
        lambda R, u: forces(*elem_args, R, u),
        lambda R, v: k_apply(*elem_args, R, v),
        lambda R: k_diag(*elem_args, R),
    )


def sharded_timestep(
    mesh: FemMesh,
    device_mesh: Mesh,
    state: FemState,
    f_ext: jax.Array,
    h: float = integ.DEFAULT_TIMESTEP,
    damping_mass: float = integ.DEFAULT_DAMPING_MASS,
    damping_stiffness: float = integ.DEFAULT_DAMPING_STIFFNESS,
    cg_tol: float = integ.CG_TOL,
    cg_max_iters: int = integ.CG_MAX_ITERS,
) -> tuple[FemState, jax.Array]:
    """One implicit step with element work sharded over `device_mesh`.

    Semantics identical to integrator.timestep (tested equal)."""
    rotations, forces, k_apply, k_diag = _shard_fns(mesh, device_mesh)
    free = ~mesh.fixed[:, None]

    R = rotations(state.q)
    f_int = forces(R, state.q)
    m = mesh.mass[:, None]

    kq = k_apply(R, state.qvel)
    residual = -h * (
        (h + damping_stiffness) * kq
        + damping_mass * m * state.qvel
        + f_int
        - f_ext
    )
    residual = jnp.where(free, residual, 0.0)

    mass_coef = 1.0 + h * damping_mass
    stiff_coef = h * damping_stiffness + h * h

    def matvec(v):
        vf = jnp.where(free, v, 0.0)
        out = mass_coef * m * vf + stiff_coef * k_apply(R, vf)
        return jnp.where(free, out, v)

    diag = mass_coef * jnp.broadcast_to(m, residual.shape) + (
        stiff_coef * k_diag(R)
    )
    diag = jnp.where(free, diag, 1.0)

    dv, iters = integ.pcg(matvec, residual, diag, cg_tol, cg_max_iters)
    qvel = jnp.where(free, state.qvel + dv, 0.0)
    q = jnp.where(free, state.q + h * qvel, 0.0)
    return FemState(q=q, qvel=qvel), iters
