"""Sharded grid-structured FEM: X-slab decomposition of the dense voxel
solver (fem.grid_fem) over a 1-D device mesh.

The multi-chip production FEM path (SURVEY §2.6 P7 on the grid solver):
vertex planes are split into contiguous X-slabs, one per device. The
stencil matvec needs exactly ONE vertex plane from the right neighbor
(cells span two adjacent planes), so per CG iteration the communication
is two one-plane `lax.ppermute`s (gather halo, return boundary
contributions) plus two scalar psums for the dots — boundary-surface
communication, like fem.partitioned but with the grid solver's
zero-gather stencil math and batched element products. XLA hands the
ppermutes and psums to NCCL (NVLink between the cards of one host).

Preconditioner (default "hybrid"): the GLOBAL multigrid V-cycle with its
fine level computed shard-wise (local smoothing + plane-halo stencil
applies + sharded full-weighting restriction) and the hierarchy from
level 1 down replicated via an all_gather of the restricted residual
(1/8 of the fine grid). Iteration counts match the replicated global
V-cycle to ~1 at 2-8 shards. Alternatives: "global_mg" (all_gather the
full fine residual — identical iterations, more traffic) and "schwarz"
(communication-free local V-cycles with Dirichlet slab walls — ~4x the
iterations). Tests pin solution equality against the single-device
solver.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..mesh.polygonize import GridSpec, TetMesh
from . import grid_fem as gfm
from .grid_fem import GridFem, build_grid_fem
from .integrator import (
    CG_MAX_ITERS,
    CG_TOL,
    DEFAULT_DAMPING_MASS,
    DEFAULT_DAMPING_STIFFNESS,
    DEFAULT_TIMESTEP,
)
from .tetmesh import DEFAULT_E, DEFAULT_NU, DEFAULT_RHO

GRID_AXIS = "x"


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedGridFem:
    """Per-shard grid FEM, leaves stacked on a leading device axis [D,...].

    local: a stacked GridFem whose dims are the EXTENDED slab
    (Xl owned vertex planes + 1 halo plane); its cellw covers exactly
    this shard's cells, its levels form the local Schwarz hierarchy
    (halo plane Dirichlet). mass/free cover the OWNED planes with
    globally-assembled values."""

    local: GridFem           # stacked [D, ...] leaves
    mass: jax.Array          # [D, Xl, Y, Z] global lumped mass, sliced
    free: jax.Array          # [D, Xl, Y, Z] bool
    kdiag: jax.Array         # [D, 3, 3, Xl*Y*Z] GLOBAL linear diag blocks
    bnd: jax.Array           # [D, Xl, Y, Z] owned planes Dirichlet-clamped
                             # in the local Schwarz solve (covered by
                             # block-Jacobi instead)
    # REPLICATED full-domain grid FEM (leaves without the D axis): its
    # multigrid hierarchy drives the default preconditioner — each shard
    # runs the identical global V-cycle on the all_gathered residual
    # (~100s of KB per CG iteration over ICI). Redundant compute, but the
    # V-cycle is ~1 ms at app grid sizes while the matvec/forces (the
    # per-iteration majority) stay sharded; precond="schwarz" switches to
    # the communication-free local cycles for scale-out grids.
    gfull: GridFem | None = None
    n_parts: int = dataclasses.field(metadata=dict(static=True), default=1)
    xl: int = dataclasses.field(metadata=dict(static=True), default=0)
    dims_pad: tuple[int, int, int] = dataclasses.field(
        metadata=dict(static=True), default=(0, 0, 0)
    )
    dims: tuple[int, int, int] = dataclasses.field(
        metadata=dict(static=True), default=(0, 0, 0)
    )

    def rest_state(self):
        z = jnp.zeros((self.n_parts, self.xl, *self.dims_pad[1:], 3),
                      jnp.float32)
        return z, z, z  # q, qvel, dv in shard layout


def make_grid_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.array(devs), (GRID_AXIS,))


def to_shard_layout(sgf: ShardedGridFem, v: jax.Array) -> jax.Array:
    """Global [X, Y, Z, 3] grid array -> [D, Xl, Y, Z, 3] shard layout
    (pads X)."""
    X = sgf.dims[0]
    xpad = sgf.n_parts * sgf.xl
    v = jnp.pad(v, [(0, xpad - X), (0, 0), (0, 0), (0, 0)])
    return v.reshape(sgf.n_parts, sgf.xl, *v.shape[1:])


def from_shard_layout(sgf: ShardedGridFem, v: jax.Array) -> jax.Array:
    """[D, Xl, Y, Z, 3] -> global [X, Y, Z, 3]."""
    flat = v.reshape(sgf.n_parts * sgf.xl, *v.shape[2:])
    return flat[: sgf.dims[0]]


def build_sharded_grid_fem(
    grid: GridSpec,
    tm: TetMesh,
    n_parts: int,
    fixed_nodes: np.ndarray | None = None,
    E: float = DEFAULT_E,
    nu: float = DEFAULT_NU,
    rho: float = DEFAULT_RHO,
    n_levels: int = 3,
) -> ShardedGridFem:
    """Host-side: build the global grid FEM, pad X so every shard gets Xl
    cells with at least one inactive padding layer at the top, slice the
    global assembled quantities per shard, and build each slab's local
    Schwarz multigrid hierarchy."""
    g = gfm.grid_fem_from_tetmesh(grid, tm, fixed_nodes=fixed_nodes,
                                  E=E, nu=nu, rho=rho, n_levels=4)
    X, Y, Z = g.dims
    CX = X - 1
    # >= 1 padding cell layer so the final vertex plane is nobody's child.
    xl = -(-(CX + 1) // n_parts)
    xl += xl % 2  # even slabs: coarse multigrid planes align with shards
    cxp = n_parts * xl
    xp = cxp + 1

    cellw = np.asarray(g.cellw).reshape(CX, Y - 1, Z - 1)
    cellw = np.pad(cellw, [(0, cxp - CX), (0, 0), (0, 0)])
    free = np.pad(np.asarray(g.free), [(0, xp - X), (0, 0), (0, 0)])
    mass = np.pad(np.asarray(g.mass), [(0, xp - X), (0, 0), (0, 0)])
    kdiag = np.asarray(g.kdiag).reshape(3, 3, X, Y, Z)
    kdiag = np.pad(kdiag, [(0, 0), (0, 0), (0, xp - X), (0, 0), (0, 0)])

    locals_, mass_sl, free_sl, kd_sl, bnd_sl = [], [], [], [], []
    for d in range(n_parts):
        cm = cellw[d * xl : (d + 1) * xl] > 0.5            # [xl, CY, CZ]
        # Local Schwarz domain: owned planes + halo plane, Dirichlet at
        # BOTH slab walls (an interior wall vertex lacks its neighbor's
        # stiffness — solving it locally overshoots and AMPLIFIES the
        # residual) and at globally-fixed/inactive vertices.
        fr = free[d * xl : (d + 1) * xl + 1].copy()        # [xl+1, Y, Z]
        fr[-1] = False                                     # halo Dirichlet
        bnd = np.zeros((xl, Y, Z), bool)
        if d > 0:
            fr[0] = False                                  # left wall
            bnd[0] = free[d * xl]                          # jacobi-covered
        lg = build_grid_fem(
            GridSpec(tuple(float(v) for v in grid.lo),
                     (xl + 1, Y, Z), grid.cellsize),
            cm, ~fr, E=E, nu=nu, rho=rho, n_levels=n_levels,
        )
        locals_.append(lg)
        mass_sl.append(mass[d * xl : (d + 1) * xl])
        free_sl.append(free[d * xl : (d + 1) * xl])
        kd_sl.append(
            kdiag[:, :, d * xl : (d + 1) * xl].reshape(3, 3, -1)
        )
        bnd_sl.append(bnd)

    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *locals_)
    return ShardedGridFem(
        local=stacked,
        mass=jnp.asarray(np.stack(mass_sl), jnp.float32),
        free=jnp.asarray(np.stack(free_sl)),
        kdiag=jnp.asarray(np.stack(kd_sl), jnp.float32),
        bnd=jnp.asarray(np.stack(bnd_sl)),
        gfull=g,
        n_parts=n_parts,
        xl=xl,
        dims_pad=(xp, Y, Z),
        dims=(X, Y, Z),
    )


def sharded_timestep(
    sgf: ShardedGridFem,
    device_mesh: Mesh,
    q: jax.Array,            # [D, Xl, Y, Z, 3] shard layout
    qvel: jax.Array,
    f_ext: jax.Array,
    h: float = DEFAULT_TIMESTEP,
    damping_mass: float = DEFAULT_DAMPING_MASS,
    damping_stiffness: float = DEFAULT_DAMPING_STIFFNESS,
    cg_tol: float = CG_TOL,
    cg_max_iters: int = CG_MAX_ITERS,
    dv: jax.Array | None = None,
    differentiable: bool = False,
    precond: str = "hybrid",
):
    """One implicit Newmark step as a single SPMD program; semantics match
    fem.grid_fem.timestep (tested equal). Returns (q', qvel', dv', iters).

    Per CG iteration: one plane ppermute in (halo gather), one plane
    ppermute out (boundary contributions), two scalar psums — plus the
    preconditioner's traffic:

      precond="hybrid"    (default) local fine-level smoothing + sharded
                          restriction, all_gather only the LEVEL-1
                          residual (1/8 of the fine grid) for the
                          replicated sub-V-cycle. Iteration counts match
                          global_mg to ~1 (measured 35-36 vs 35-37 at
                          2/4/8 shards on the ventricle mesh vs 36
                          single-device; schwarz needs 86-140). Falls
                          back to global_mg when the hierarchy has a
                          single level or slabs are odd.
      precond="global_mg" all_gather the FULL fine residual every
                          iteration for a replicated global V-cycle —
                          iteration counts identical to single-device,
                          traffic grows with global N.
      precond="schwarz"   communication-free local V-cycles (Dirichlet
                          slab walls) — zero preconditioner traffic, ~4x
                          the iterations at 8 shards."""
    D, Xl = sgf.n_parts, sgf.xl
    X = sgf.dims[0]
    Y, Z = sgf.dims[1], sgf.dims[2]
    perm_fwd = [(s, s - 1) for s in range(1, D)]   # halo plane flows left
    perm_bwd = [(s, s + 1) for s in range(D - 1)]  # contributions flow right
    mass_coef = 1.0 + h * damping_mass
    stiff_coef = h * damping_stiffness + h * h
    if dv is None:
        dv = jnp.zeros_like(q)

    sgf_spec = jax.tree_util.tree_map(lambda _: P(GRID_AXIS), sgf)
    if sgf.gfull is not None:  # replicated subtree
        sgf_spec = dataclasses.replace(
            sgf_spec,
            gfull=jax.tree_util.tree_map(lambda _: P(), sgf.gfull),
        )

    @partial(
        shard_map,
        mesh=device_mesh,
        in_specs=(
            sgf_spec,
            P(GRID_AXIS), P(GRID_AXIS), P(GRID_AXIS), P(GRID_AXIS),
        ),
        out_specs=(P(GRID_AXIS), P(GRID_AXIS), P(GRID_AXIS), P()),
        check_vma=False,
    )
    def step(sgf_s, q, qvel, f_ext, dv0):
        lgf: GridFem = jax.tree_util.tree_map(lambda x: x[0], sgf_s.local)
        mass = sgf_s.mass[0]
        free = sgf_s.free[0][..., None]
        q, qvel, f_ext, dv0 = q[0], qvel[0], f_ext[0], dv0[0]
        m = mass[..., None]

        def exchange(v):
            """Owned [Xl,Y,Z,3] -> extended [Xl+1,Y,Z,3]: halo plane from
            the right neighbor's first owned plane (zeros past the end)."""
            halo = jax.lax.ppermute(v[0:1], GRID_AXIS, perm_fwd)
            return jnp.concatenate([v, halo], 0)

        def collect(ext):
            """Extended contributions -> owned: the halo-plane rows belong
            to the right neighbor; send them there and add at its first
            plane."""
            recv = jax.lax.ppermute(ext[Xl : Xl + 1], GRID_AXIS, perm_bwd)
            own = ext[:Xl]
            return own.at[0:1].add(recv)

        q_ext = exchange(jnp.where(free, q, 0.0))
        qvel_ext = exchange(jnp.where(free, qvel, 0.0))
        R = gfm.kinematics(lgf, q_ext)
        f_int = collect(gfm.internal_forces(lgf, q_ext, R))
        kq = collect(gfm.stiffness_apply_rot(lgf, R, qvel_ext))

        residual = -h * (
            (h + damping_stiffness) * kq
            + damping_mass * m * qvel
            + f_int
            - f_ext
        )
        residual = jnp.where(free, residual, 0.0)

        def matvec(v):
            vf = jnp.where(free, v, 0.0)
            out = mass_coef * m * vf + stiff_coef * collect(
                gfm.stiffness_apply_rot(lgf, R, exchange(vf))
            )
            return jnp.where(free, out, v)

        if (precond == "hybrid" and sgf_s.gfull is not None
                and len(sgf_s.gfull.levels) > 1 and Xl % 2 == 0
                # The sharded restriction produces D*(Xl/2) coarse X
                # planes; if the global hierarchy has MORE (odd-X
                # grids), the topmost coarse plane would be zero-filled
                # on restriction but still prolonged — restriction and
                # prolongation would no longer be exact adjoints and
                # PCG's SPD requirement would be silently violated
                # (ADVICE r4 #4). Fall back to global_mg then.
                and D * (Xl // 2) >= sgf_s.gfull.levels[1].dims[0]):
            # HYBRID multigrid (round 4, VERDICT r3 #5): the global
            # V-cycle computed shard-wise at the FINE level — local
            # block-Jacobi smoothing + linear stencil applies with plane
            # halos, sharded full-weighting restriction — and replicated
            # only from level 1 down: the all_gather moves the RESTRICTED
            # residual (1/8 of the fine grid) instead of the full fine
            # residual, so per-CG-iteration traffic is bounded by a few
            # halo planes + the coarse hierarchy. Same cycle math as
            # precond="global_mg" (iteration counts match to ~1, modulo
            # the topmost coarse plane when D*Xl/2 == Xc-1).
            gfull: GridFem = sgf_s.gfull
            pre_inv = None
            if (
                gfull.coarse_inv is not None
                and abs(mass_coef - gfull.coarse_coefs[0]) < 1e-12
                and abs(stiff_coef - gfull.coarse_coefs[1]) < 1e-12
            ):
                pre_inv = gfull.coarse_inv
            setup_sub = gfm.mg_setup(
                gfull.levels[1:], mass_coef, stiff_coef, pre_inv
            )
            lvl1 = gfull.levels[1]
            Xc, Yc, Zc = lvl1.dims
            Xlc = Xl // 2
            d_idx = jax.lax.axis_index(GRID_AXIS)
            # Fine-level smoother: globally-assembled diagonal blocks of
            # the linear operator on the owned planes.
            mflat = mass.reshape(-1)
            eye3 = jnp.eye(3, dtype=q.dtype)[..., None]
            blk0 = (mass_coef * mflat) * eye3 + stiff_coef * sgf_s.kdiag[0]
            freef0 = sgf_s.free[0].reshape(-1)[None, None]
            blk0 = jnp.where(freef0, blk0, eye3)
            inv_b0 = gfm._inv3_cm(blk0)

            def lin_mv(v):
                """Fine-level LINEAR (rest) operator on owned planes —
                the level-0 operator of the global hierarchy, computed
                with one halo exchange."""
                vf = jnp.where(free, v, 0.0)
                out = mass_coef * m * vf + stiff_coef * collect(
                    gfm._un_cm(gfm._stiffness_apply_linear(
                        (Xl + 1, Y, Z), lgf.cellw, lgf.ke,
                        gfm._cm(exchange(vf)),
                    ))
                )
                return jnp.where(free, out, 0.0)

            def jac(r):
                return gfm._OMEGA * jnp.where(free, gfm._un_cm(
                    gfm._block_apply(inv_b0, gfm._cm(r), None)
                ), 0.0)

            def prec(r):
                r = jnp.where(free, r, 0.0)
                z1 = jac(r)                               # pre-smooth
                res1 = jnp.where(free, r - lin_mv(z1), 0.0)
                # Sharded full-weighting restrict along X: coarse plane
                # gi = d*Xlc + i sits at owned fine plane 2i; f[2i-1] for
                # i = 0 is the LEFT neighbor's last plane.
                left = jax.lax.ppermute(
                    res1[Xl - 1 : Xl], GRID_AXIS, perm_bwd
                )
                ext = jnp.concatenate([left, res1], 0)    # planes -1..Xl-1
                even = ext[1::2][:Xlc]                    # f[2i]
                fm1 = ext[0::2][:Xlc]                     # f[2i-1]
                fp1 = ext[2::2][:Xlc]                     # f[2i+1]
                rc_x = even + 0.5 * (fm1 + fp1)           # [Xlc, Y, Z, 3]
                rc = gfm._cm(rc_x)                        # [3, Xlc, Y, Z]
                rc = gfm._restrict_axis(rc, Yc, 2)
                rc = gfm._restrict_axis(rc, Zc, 3)
                rcg = jax.lax.all_gather(
                    rc, GRID_AXIS, axis=1, tiled=True
                )                                         # [3,D*Xlc,Yc,Zc]
                pad_c = max(0, Xc - D * Xlc)
                if pad_c:
                    rcg = jnp.pad(
                        rcg, [(0, 0), (0, pad_c), (0, 0), (0, 0)]
                    )
                rcg = rcg[:, :Xc]
                # Replicated sub-V-cycle on levels 1..end.
                zcg = gfm.vcycle(
                    gfull.levels[1:], mass_coef, stiff_coef,
                    gfm._un_cm(rcg), setup_sub,
                )
                zg3 = gfm._cm(zcg)                        # [3, Xc, Yc, Zc]
                pad_t = D * Xlc + 1 - Xc
                if pad_t > 0:
                    zg3 = jnp.pad(
                        zg3, [(0, 0), (0, pad_t), (0, 0), (0, 0)]
                    )
                c_own = jax.lax.dynamic_slice_in_dim(
                    zg3, d_idx * Xlc, Xlc + 1, 1
                )                                         # [3, Xlc+1, ...]
                c_own = gfm._prolong_axis(c_own, Y, 2)
                c_own = gfm._prolong_axis(c_own, Z, 3)
                ev = c_own[:, :Xlc]
                od = 0.5 * (c_own[:, :Xlc] + c_own[:, 1 : Xlc + 1])
                zp = jnp.stack([ev, od], 2).reshape(3, Xl, Y, Z)
                z2 = z1 + jnp.where(free, gfm._un_cm(zp), 0.0)
                # post-smooth (symmetric V(1,1))
                z3 = z2 + jac(r - lin_mv(z2))
                return jnp.where(free, z3, 0.0)
        elif (precond in ("global_mg", "hybrid")
                and sgf_s.gfull is not None):
            # (a hybrid request that failed its exactness gate above
            # falls back here, NOT to schwarz — same iteration counts,
            # just more all_gather traffic)
            # Replicated global V-cycle on the all_gathered residual:
            # iteration counts match the single-device solver exactly.
            gfull: GridFem = sgf_s.gfull
            pre_inv = None
            if (
                gfull.coarse_inv is not None
                and abs(mass_coef - gfull.coarse_coefs[0]) < 1e-12
                and abs(stiff_coef - gfull.coarse_coefs[1]) < 1e-12
            ):
                pre_inv = gfull.coarse_inv
            setup_g = gfm.mg_setup(
                gfull.levels, mass_coef, stiff_coef, pre_inv
            )
            d_idx = jax.lax.axis_index(GRID_AXIS)

            def prec(r):
                rg = jax.lax.all_gather(
                    r, GRID_AXIS, axis=0, tiled=True
                )                                      # [D*Xl, Y, Z, 3]
                z = gfm.vcycle(
                    gfull.levels, mass_coef, stiff_coef, rg[:X], setup_g
                )
                z = jnp.pad(z, [(0, D * Xl - X), (0, 0), (0, 0), (0, 0)])
                own = jax.lax.dynamic_slice_in_dim(z, d_idx * Xl, Xl, 0)
                return jnp.where(free, own, 0.0)
        else:
            # Additive Schwarz: local V-cycle per shard on the slab
            # INTERIOR (both walls Dirichlet) plus a block-Jacobi sweep on
            # the wall-clamped owned plane (keeps the preconditioner PD
            # there). Zero communication.
            pre_inv = None
            if (
                lgf.coarse_inv is not None
                and abs(mass_coef - lgf.coarse_coefs[0]) < 1e-12
                and abs(stiff_coef - lgf.coarse_coefs[1]) < 1e-12
            ):
                pre_inv = lgf.coarse_inv
            setup = gfm.mg_setup(lgf.levels, mass_coef, stiff_coef, pre_inv)

            bnd = sgf_s.bnd[0][..., None]              # [Xl, Y, Z, 1]
            mflat = mass.reshape(-1)
            eye3 = jnp.eye(3, dtype=q.dtype)[..., None]
            blocks = (
                (mass_coef * mflat) * eye3 + stiff_coef * sgf_s.kdiag[0]
            )
            freef = (sgf_s.free[0] & sgf_s.bnd[0]).reshape(-1)[None, None]
            blocks = jnp.where(freef, blocks, eye3)
            inv_blocks = gfm._inv3_cm(blocks)

            def prec(r):
                r_ext = jnp.concatenate([r, jnp.zeros_like(r[0:1])], 0)
                z = gfm.vcycle(
                    lgf.levels, mass_coef, stiff_coef, r_ext, setup
                )
                zj = gfm._un_cm(
                    gfm._block_apply(inv_blocks, gfm._cm(r), None)
                )
                z = jnp.where(bnd, zj, z[:Xl])
                return jnp.where(free, z, 0.0)

        def pdot(a, b):
            return jax.lax.psum(jnp.vdot(a, b), GRID_AXIS)

        def pcg(b, x0):
            thresh = (cg_tol * cg_tol) * pdot(b, prec(b))
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
                return (x, r, z + beta * p, rz_new, it + 1)

            x, r, p, rz, it = jax.lax.while_loop(
                cond, body, (x, r, p, rz, 0)
            )
            return x, it

        if differentiable:
            dvn = jax.lax.custom_linear_solve(
                matvec,
                residual,
                solve=lambda mv, bb: pcg(bb, jnp.zeros_like(bb))[0],
                symmetric=True,
            )
            iters = jnp.asarray(-1, jnp.int32)
        else:
            dvn, iters = pcg(residual, jnp.where(free, dv0, 0.0))

        qvel2 = jnp.where(free, qvel + dvn, 0.0)
        q2 = jnp.where(free, q + h * qvel2, 0.0)
        return q2[None], qvel2[None], dvn[None], iters

    return step(sgf, q, qvel, f_ext, dv)
