"""Partitioned-node sharded FEM: halo exchange instead of full replication.

fem.sharded replicates nodal state and psums the full [N, 3] assembly
every CG iteration — fine at truth-cube scale, dominated by the
all-reduce at brain scale. This module is the SURVEY §2.6 P7 design
proper: NODES are partitioned (1-D spatial split, contiguous renumber),
each shard owns its node block plus the tetrahedra anchored there, and
the only per-iteration communication is a boundary-layer halo exchange
with the RIGHT neighbor (`lax.ppermute`) — communication scales with the
partition boundary, not with N.

Topology invariant (asserted at build): with nodes sorted along the
split axis and tets assigned to their minimum-corner's partition, every
non-owned corner belongs to the NEXT partition (tet edges span at most
one voxel layer). Per CG iteration each shard does: send its
left-boundary rows left (one ppermute), apply the local rotated
stiffness, return halo contributions right (one ppermute), plus two
scalar psums for the CG dots.

The whole implicit step — kinematics, forces, block-Jacobi setup, CG —
runs inside ONE shard_map'ed jit: a single SPMD program per step.
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
from .tetmesh import FemMesh, build_fem_mesh

NODE_AXIS = "nodes"


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PartFemMesh:
    """Per-shard FEM arrays, stacked on a leading partition axis [D, ...].
    'ext' = owned rows followed by halo rows (received from the right
    neighbor); tets index into that extended local space."""

    rest_ext: jax.Array    # [D, Nl+H, 3]
    tets: jax.Array        # [D, Tl, 4] extended-local indices
    inv_dm: jax.Array      # [D, Tl, 3, 3]
    ke: jax.Array          # [D, Tl, 12, 12]
    mass: jax.Array        # [D, Nl]
    free_ext: jax.Array    # [D, Nl+H] bool (owned + halo free mask)
    send_idx: jax.Array    # [D, H] rows THIS shard sends to its LEFT
    perm: jax.Array        # [N] original node id -> partition order
    n_parts: int = dataclasses.field(metadata=dict(static=True), default=1)
    n_local: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_halo: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_nodes: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def halo_bytes_per_exchange(self) -> int:
        """Per-iteration communication volume (one direction)."""
        return self.n_parts * self.n_halo * 3 * 4


def _rcm_order(n: int, tets: np.ndarray) -> np.ndarray:
    """Reverse Cuthill–McKee ordering of the tet-mesh node graph.

    Bandwidth-minimizing fallback for meshes where no coordinate sort
    keeps every tet within two adjacent partitions (e.g. after
    cut-induced re-tessellation shuffles node ids — VERDICT r2 #4)."""
    # CSR adjacency from tet edges.
    pairs = []
    for a in range(4):
        for b in range(a + 1, 4):
            pairs.append(tets[:, [a, b]])
    e = np.concatenate(pairs, 0)
    e = np.concatenate([e, e[:, ::-1]], 0)
    e = np.unique(e, axis=0)
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, e[:, 0] + 1, 1)
    indptr = np.cumsum(indptr)
    indices = e[np.argsort(e[:, 0], kind="stable"), 1]
    deg = np.diff(indptr)

    visited = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    pos = 0
    # Process components from lowest-degree unvisited seeds.
    seeds = np.argsort(deg, kind="stable")
    for s in seeds:
        if visited[s]:
            continue
        visited[s] = True
        order[pos] = s
        head, pos = pos, pos + 1
        while head < pos:
            v = order[head]
            head += 1
            nbr = indices[indptr[v]:indptr[v + 1]]
            nbr = nbr[~visited[nbr]]
            nbr = nbr[np.argsort(deg[nbr], kind="stable")]
            visited[nbr] = True
            order[pos:pos + len(nbr)] = nbr
            pos += len(nbr)
    return order[::-1].copy()  # reverse CM


def _split_ok(stets: np.ndarray, n_local: int, n_parts: int) -> bool:
    """Every tet must fit inside its min-corner partition plus the next
    one (the halo-exchange topology invariant)."""
    p_min = np.minimum(stets.min(1) // n_local, n_parts - 1)
    return bool(np.all(stets.max(1) < (p_min + 2) * n_local))


def build_partitioned(nodes: np.ndarray, tets: np.ndarray, n_parts: int,
                      fixed: np.ndarray | None = None,
                      axis: int | None = None, **material) -> PartFemMesh:
    """Partition a tet mesh for node-sharded solving.

    Orders nodes so each tet spans at most two ADJACENT contiguous blocks
    (the halo topology invariant): tries coordinate sorts along each axis
    (tightest-span first; `axis` forces one) and falls back to a reverse
    Cuthill–McKee bandwidth-minimizing ordering for meshes no coordinate
    sort can split (e.g. after cutting re-tessellates the topology).
    Splits into n_parts blocks (padded with immovable dummy nodes),
    assigns each tet to its minimum corner's partition, and builds
    per-shard halo index maps. Raises only if even RCM cannot satisfy the
    invariant (then n_parts is too large for this mesh)."""
    nodes = np.asarray(nodes, np.float64)
    tets = np.asarray(tets, np.int64)
    n = len(nodes)
    n_local = -(-n // n_parts)

    if axis is not None:
        candidates = [np.argsort(nodes[:, axis], kind="stable")]
    else:
        # Longest spatial extent first: fewest nodes per cross-section,
        # so the contiguous split has the smallest boundary.
        spans = nodes.max(0) - nodes.min(0)
        candidates = [
            np.argsort(nodes[:, a], kind="stable")
            for a in np.argsort(-spans)
        ]
    candidates.append(None)  # RCM sentinel (built lazily — O(E) work)

    order = None
    for cand in candidates:
        if cand is None:
            cand = _rcm_order(n, tets)
        inv = np.empty(n, np.int64)
        inv[cand] = np.arange(n)
        if n_parts == 1 or _split_ok(inv[tets], n_local, n_parts):
            order = cand
            break
    if order is None:
        raise ValueError(
            f"no node ordering (coordinate sorts or RCM) keeps every tet "
            f"within adjacent partitions at n_parts={n_parts}; "
            f"reduce n_parts for this mesh"
        )
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    snodes = nodes[order]
    stets = inv[tets]

    fixed_mask = np.zeros(n, bool)
    if fixed is not None:
        fixed_mask[np.asarray(fixed, np.int64)] = True
    sfixed = fixed_mask[order]

    n_local = -(-n // n_parts)
    n_pad = n_parts * n_local
    if n_pad > n:  # dummy fixed nodes at +inf-ish, never referenced
        pad = n_pad - n
        snodes = np.concatenate([snodes, np.zeros((pad, 3))])
        sfixed = np.concatenate([sfixed, np.ones(pad, bool)])

    part_of = np.minimum(stets.min(1) // n_local, n_parts - 1)

    # Element matrices in the sorted frame (shared precompute).
    ref = build_fem_mesh(snodes, stets, fixed=np.nonzero(sfixed)[0],
                         **material)
    ke = np.asarray(ref.ke)
    inv_dm = np.asarray(ref.inv_dm)
    mass = np.asarray(ref.mass)  # [n_pad] (snodes already padded)

    # Per-partition tet lists + halo maps.
    tl = max(int((part_of == p).sum()) for p in range(n_parts))
    halos: list[np.ndarray] = []
    for p in range(n_parts):
        lo, hi = p * n_local, (p + 1) * n_local
        pt = stets[part_of == p]
        out_ids = np.unique(pt[(pt < lo) | (pt >= hi)])
        if out_ids.size and (
            out_ids.min() < lo or out_ids.max() >= hi + n_local
        ):
            raise ValueError(
                f"partition {p}: tets span non-adjacent partitions "
                f"(n_parts={n_parts} too large for this mesh)"
            )
        halos.append(out_ids)
    H = max((h.size for h in halos), default=0)
    H = max(H, 1)  # keep shapes non-degenerate

    D = n_parts
    tets_l = np.zeros((D, tl, 4), np.int32)
    ke_l = np.zeros((D, tl, 12, 12), np.float32)
    invdm_l = np.tile(np.eye(3, dtype=np.float32), (D, tl, 1, 1))
    send_idx = np.zeros((D, H), np.int32)
    free_ext = np.zeros((D, n_local + H), bool)
    rest_ext = np.zeros((D, n_local + H, 3), np.float32)

    for p in range(D):
        lo, hi = p * n_local, (p + 1) * n_local
        sel = part_of == p
        pt = stets[sel]
        k = pt.shape[0]
        halo = halos[p]  # global ids owned by p+1, needed by p
        # extended-local remap: owned -> id-lo, halo -> n_local + rank
        ext_of = {}
        for r, g in enumerate(halo):
            ext_of[int(g)] = n_local + r
        loc = np.where(
            (pt >= lo) & (pt < hi),
            pt - lo,
            np.vectorize(lambda g: ext_of.get(int(g), 0))(pt)
            if pt.size else pt,
        )
        tets_l[p, :k] = loc
        ke_l[p, :k] = ke[sel]
        invdm_l[p, :k] = inv_dm[sel]
        rest_ext[p, :n_local] = snodes[lo:hi]
        free_ext[p, :n_local] = ~sfixed[lo:hi]
        rest_ext[p, n_local : n_local + halo.size] = snodes[halo]
        free_ext[p, n_local : n_local + halo.size] = ~sfixed[halo]
        # shard p+1 must SEND these rows (its local ids) to p:
        if p + 1 < D and halo.size:
            send_idx[p + 1, : halo.size] = (halo - (p + 1) * n_local).astype(
                np.int32
            )

    return PartFemMesh(
        rest_ext=jnp.asarray(rest_ext),
        tets=jnp.asarray(tets_l),
        inv_dm=jnp.asarray(invdm_l),
        ke=jnp.asarray(ke_l),
        mass=jnp.asarray(mass.reshape(D, n_local).astype(np.float32)),
        free_ext=jnp.asarray(free_ext),
        send_idx=jnp.asarray(send_idx),
        perm=jnp.asarray(order.astype(np.int32)),
        n_parts=D,
        n_local=n_local,
        n_halo=H,
        n_nodes=n,
    )


def to_partition_order(pm: PartFemMesh, arr: jax.Array) -> jax.Array:
    """[N, 3] in original node ids -> [D, Nl, 3] partition layout."""
    pad = pm.n_parts * pm.n_local - pm.n_nodes
    a = arr[pm.perm]
    if pad:
        a = jnp.concatenate([a, jnp.zeros((pad, 3), arr.dtype)])
    return a.reshape(pm.n_parts, pm.n_local, 3)


def from_partition_order(pm: PartFemMesh, arr: jax.Array) -> jax.Array:
    """[D, Nl, 3] partition layout -> [N, 3] original node ids."""
    flat = arr.reshape(-1, 3)[: pm.n_nodes]
    out = jnp.zeros_like(flat)
    return out.at[pm.perm].set(flat)


def partitioned_timestep(
    pm: PartFemMesh,
    device_mesh: Mesh,
    q: jax.Array,            # [D, Nl, 3] partition layout
    qvel: jax.Array,
    f_ext: jax.Array,
    h: float = integ.DEFAULT_TIMESTEP,
    damping_mass: float = integ.DEFAULT_DAMPING_MASS,
    damping_stiffness: float = integ.DEFAULT_DAMPING_STIFFNESS,
    cg_tol: float = integ.CG_TOL,
    cg_max_iters: int = integ.CG_MAX_ITERS,
    dv: jax.Array | None = None,
    differentiable: bool = False,
):
    """One implicit step, node-partitioned. Semantics match
    integrator.timestep (tested equal); per-CG-iteration communication is
    two H-row ppermutes + two scalar psums instead of a full [N,3] psum.

    dv ([D, Nl, 3], the previous step's velocity delta) warm-starts the
    CG exactly like integrator.timestep's FemState.dv — the stopping rule
    is |b|-relative, so the warm start cuts iterations rather than
    tightening the tolerance. differentiable=True wraps the distributed
    solve in `lax.custom_linear_solve` (the ppermute halo exchange is
    linear, so the adjoint solve reuses the same SPMD matvec), enabling
    reverse-mode through the sharded step — the coupled sharded path
    needs this for training. Returns (q', qvel', dv', cg_iters)."""
    Nl, Hh = pm.n_local, pm.n_halo
    D = pm.n_parts
    perm_fwd = [(s, s - 1) for s in range(1, D)]   # halo values flow left
    perm_bwd = [(s, s + 1) for s in range(D - 1)]  # contributions flow right

    mesh_args = (pm.rest_ext, pm.tets, pm.inv_dm, pm.ke, pm.mass,
                 pm.free_ext, pm.send_idx)
    spec = (P(NODE_AXIS),) * len(mesh_args)
    if dv is None:
        dv = jnp.zeros_like(q)

    @partial(
        shard_map,
        mesh=device_mesh,
        in_specs=spec + (P(NODE_AXIS),) * 4,
        out_specs=(P(NODE_AXIS), P(NODE_AXIS), P(NODE_AXIS), P()),
        check_vma=False,
    )
    def step(rest_ext, tets, inv_dm, ke, mass, free_ext, send_idx,
             q, qvel, f_ext, dv0):
        # shard_map blocks keep the leading axis of size 1 — drop it.
        rest_ext, tets, inv_dm, ke = (
            rest_ext[0], tets[0], inv_dm[0], ke[0]
        )
        mass, free_ext, send_idx = mass[0], free_ext[0], send_idx[0]
        q, qvel, f_ext, dv0 = q[0], qvel[0], f_ext[0], dv0[0]

        free = free_ext[:Nl, None]
        free_e = free_ext[:, None]
        m = mass[:, None]

        def exchange(v):
            """Owned rows [Nl,3] -> extended [Nl+H,3] with halo from the
            right neighbor (rows it owns that our tets reference)."""
            send = v[send_idx]  # rows our LEFT neighbor needs from us
            halo = jax.lax.ppermute(send, NODE_AXIS, perm_fwd)
            return jnp.concatenate([v, halo], 0)

        def collect(ext):
            """Extended contributions -> owned rows: send halo part back
            to its owner (right neighbor) and add at its send rows."""
            recv = jax.lax.ppermute(ext[Nl:], NODE_AXIS, perm_bwd)
            own = ext[:Nl]
            return own.at[send_idx].add(recv)

        lm = FemMesh(
            rest=rest_ext, tets=tets, inv_dm=inv_dm,
            volume=jnp.zeros(tets.shape[0]), ke=ke,
            mass=jnp.zeros(rest_ext.shape[0]),
            fixed=~free_ext, node_gather=None,
            n_nodes=rest_ext.shape[0], n_tets=tets.shape[0],
        )

        q_ext = exchange(q)
        qvel_ext = exchange(qvel)
        _, R = co.element_kinematics(lm, q_ext)
        krot = co.rotated_stiffness(lm, R)
        f_int = collect(co.internal_forces(lm, q_ext, R))
        kq = collect(co.stiffness_apply_pre(lm, krot, qvel_ext))

        residual = -h * (
            (h + damping_stiffness) * kq
            + damping_mass * m * qvel
            + f_int
            - f_ext
        )
        residual = jnp.where(free, residual, 0.0)

        mass_coef = 1.0 + h * damping_mass
        stiff_coef = h * damping_stiffness + h * h

        def matvec(v):
            vf = jnp.where(free, v, 0.0)
            ve = jnp.where(free_e, exchange(vf), 0.0)
            out = mass_coef * m * vf + stiff_coef * collect(
                co.stiffness_apply_pre(lm, krot, ve)
            )
            return jnp.where(free, out, v)

        eye = jnp.eye(3, dtype=residual.dtype)
        # collect() is width-agnostic: block rows travel as [*, 9].
        blk = collect(co.stiffness_blocks(lm, krot).reshape(-1, 9))
        blk = blk.reshape(Nl, 3, 3)
        blocks = (mass_coef * m)[..., None] * eye + stiff_coef * blk
        blocks = jnp.where(free[..., None], blocks, eye)
        inv_blocks = co._inv3(blocks)

        def prec(r):
            return jnp.einsum("nab,nb->na", inv_blocks, r,
                              precision=jax.lax.Precision.HIGHEST)

        def pdot(a, b):
            return jax.lax.psum(jnp.vdot(a, b), NODE_AXIS)

        # PCG with distributed dots (mirrors integrator.pcg).
        def run_pcg(b, x0=None):
            thresh = (cg_tol * cg_tol) * pdot(b, prec(b))
            if x0 is None:
                x = jnp.zeros_like(b)
                r = b
            else:
                x = x0
                r = b - matvec(x0)
            z = prec(r)
            p = z
            rz = pdot(r, z)

            def cond(s):
                x, r, p, rz, it = s
                return (rz > thresh) & (it < cg_max_iters)

            def body(s):
                x, r, p, rz, it = s
                ap = matvec(p)
                alpha = rz / jnp.maximum(pdot(p, ap), 1e-30)
                x = x + alpha * p
                r = r - alpha * ap
                z = prec(r)
                rz_new = pdot(r, z)
                beta = rz_new / jnp.maximum(rz, 1e-30)
                p = z + beta * p
                return (x, r, p, rz_new, it + 1)

            x, r, p, rz, it = jax.lax.while_loop(
                cond, body, (x, r, p, rz, 0)
            )
            return x, it

        if differentiable:
            # No warm start: custom_linear_solve reuses `solve` for the
            # adjoint system, where the primal guess would be wrong. The
            # matvec's ppermutes/psums are linear, so the implicit-
            # function adjoint is one more distributed solve.
            dv_new = jax.lax.custom_linear_solve(
                matvec,
                residual,
                solve=lambda mv, b: run_pcg(b)[0],
                symmetric=True,
            )
            it = jnp.asarray(-1, jnp.int32)
        else:
            x0 = jnp.where(free, dv0, 0.0)
            dv_new, it = run_pcg(residual, x0)

        qvel_new = jnp.where(free, qvel + dv_new, 0.0)
        q_new = jnp.where(free, q + h * qvel_new, 0.0)
        return q_new[None], qvel_new[None], dv_new[None], it

    return step(*mesh_args, q, qvel, f_ext, dv)
