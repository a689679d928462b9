"""Grid-structured corotational FEM: the production solver.

The embedded tet mesh is 6 Kuhn tets per active voxel of a REGULAR grid
(mesh.polygonize.extract_tet_mesh, reference Tetrahedralizer.cl:67-132).
The unstructured solver (fem.integrator over fem.corotational) treats it
as an arbitrary tet soup, so every CG matvec pays a [T,4] gather and a
[T*4]->[N] scatter. This module exploits the structure instead:

  * displacements live DENSE on the grid; corner access is 8 static
    slices and assembly is 8 padded adds — zero gathers or scatters;
  * every cell is the same cube, so the 6 Kuhn element stiffnesses are
    ONE shared [6, 12, 12] table — the per-element product becomes a
    matmul over all cells;
  * all hot arrays are CHANNEL-MAJOR with the flattened cell axis last
    ([12, C], [3, 3, C]), so elementwise work runs along the long cell
    axis instead of a size-3 trailing axis;
  * a geometric MULTIGRID V-cycle (vertex-centered coarsening, linear
    rest-stiffness rediscretized per level) preconditions CG, replacing
    the reference's Jacobi (vegafem sparseSolver/CGSolver.cpp:146-149)
    whose iteration count at ventricle scale is ~1000.

Semantics match fem.integrator.timestep exactly (same Newmark/PCG scheme,
same corotational forces — tests/test_grid_fem.py pins equality against
the unstructured path on the same mesh); only the data layout changes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from ..mesh import tables as T
from ..mesh.polygonize import GridSpec, TetMesh
from .integrator import (
    CG_MAX_ITERS,
    CG_TOL,
    DEFAULT_DAMPING_MASS,
    DEFAULT_DAMPING_STIFFNESS,
    DEFAULT_TIMESTEP,
    FemState,
    pcg,
)
from .tetmesh import DEFAULT_E, DEFAULT_NU, DEFAULT_RHO, _element_stiffness

_F32 = jax.lax.Precision.HIGHEST

# Per-corner lumped-mass weights: corner b of a cell receives
# (#tets containing b) / 24 of the cell's mass (each Kuhn tet has volume
# s^3/6 shared by 4 corners). Corners 0 and 7 sit on all 6 tets.
_CORNER_MASS_W = np.zeros(8)
for _k in range(6):
    for _j in range(4):
        _CORNER_MASS_W[T.TET_CORNERS[_k, _j]] += 1.0 / 24.0

# Damped block-Jacobi smoother inside the V-cycle.
_OMEGA = 0.6
_NU_SMOOTH = 1

_POLAR_ITERS = 6


def _kuhn_elements(cellsize: float, E: float, nu: float):
    """Shared element data for the 6 Kuhn tets of an s-cube (float64):
    ke [6,12,12], inv_dm [6,3,3], rest corner positions x0 [6,4,3]."""
    corners = T.CORNER_OFFSET.astype(np.float64) * cellsize  # [8,3]
    verts = corners[T.TET_CORNERS]                           # [6,4,3]
    ke, vol, inv_dm, _ = _element_stiffness(verts, E, nu)
    assert np.all(vol > 0)
    return ke, inv_dm, verts


def _linear_diag_blocks_table(ke: np.ndarray) -> np.ndarray:
    """[8,3,3] per-cube-corner diagonal stiffness blocks: corner b of an
    active cell contributes sum over (tet k, corner j) with
    TET_CORNERS[k,j] == b of ke[k][3j:3j+3, 3j:3j+3]."""
    out = np.zeros((8, 3, 3))
    for k in range(6):
        for j in range(4):
            b = T.TET_CORNERS[k, j]
            out[b] += ke[k, 3 * j : 3 * j + 3, 3 * j : 3 * j + 3]
    return out


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GridLevel:
    """One multigrid level: the linear (rest, R = I) elasticity operator
    on its own vertex grid, rediscretized at this level's cell size."""

    cellw: jax.Array   # [CX*CY*CZ] f32 cell weights (1 = active)
    free: jax.Array    # [X,Y,Z] bool — active node and not fixed
    mass: jax.Array    # [X,Y,Z] f32 lumped mass
    ke: jax.Array      # [6,12,12] shared element stiffness
    kdiag: jax.Array   # [3,3,X*Y*Z] assembled linear diag blocks of K
    # Dense assembled operator pieces for the COARSEST level only
    # (None elsewhere): K [D,D] with fixed rows/cols zeroed, free [D]
    # 0/1 — the coarse-grid solve is then one small dense inverse+matmul
    # instead of launch-bound smoother sweeps.
    k_dense: jax.Array | None = None
    free_dense: jax.Array | None = None
    dims: tuple[int, int, int] = dataclasses.field(
        metadata=dict(static=True), default=(0, 0, 0)
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GridFem:
    """Grid FEM mesh: fine level + coarser multigrid levels. Float leaves
    are differentiable (ke carries the E dependence)."""

    cellw: jax.Array   # [CX*CY*CZ] f32 active-cell weights
    free: jax.Array    # [X,Y,Z] bool
    active: jax.Array  # [X,Y,Z] bool (tet nodes)
    mass: jax.Array    # [X,Y,Z] f32
    ke: jax.Array      # [6,12,12]
    inv_dm: jax.Array  # [6,3,3]
    x0: jax.Array      # [6,12] rest corner positions within a cell
    kdiag: jax.Array   # [3,3,X*Y*Z] linear diag blocks (fallback prec)
    levels: tuple[GridLevel, ...]
    # Coarse-level operator inverse precomputed on the HOST for the
    # default (mass_coef, stiff_coef), so a step does not pay a dense
    # inverse. Rebuilt in-graph only when a step uses non-default
    # h/damping.
    coarse_inv: jax.Array | None = None
    coarse_coefs: tuple[float, float] = dataclasses.field(
        metadata=dict(static=True), default=(0.0, 0.0)
    )
    origin: tuple[float, float, float] = dataclasses.field(
        metadata=dict(static=True), default=(0.0, 0.0, 0.0)
    )
    dims: tuple[int, int, int] = dataclasses.field(
        metadata=dict(static=True), default=(0, 0, 0)
    )
    cellsize: float = dataclasses.field(
        metadata=dict(static=True), default=0.0
    )

    def rest_state(self) -> FemState:
        z = jnp.zeros((*self.dims, 3), jnp.float32)
        return FemState(q=z, qvel=z, dv=z)


# ----------------------------------------------------- channel-major core
#
# Hot-path representation: vectors over cells are [12, C] (corner-coord
# channels leading, flattened cells last); 3x3 matrix
# fields are [3, 3, C]. Grid vectors are [3, X, Y, Z].

def _cm(u):
    """[X,Y,Z,3] -> [3,X,Y,Z]."""
    return jnp.moveaxis(u, -1, 0)


def _un_cm(u3):
    return jnp.moveaxis(u3, 0, -1)


def _corner_rows(dims, u3):
    """u3 [3,X,Y,Z] -> list of 8 [3, C] corner-value blocks (static
    slices + reshape, no gather)."""
    X, Y, Z = dims
    out = []
    for b in range(8):
        ox, oy, oz = (int(t) for t in T.CORNER_OFFSET[b])
        sl = u3[:, ox : ox + X - 1, oy : oy + Y - 1, oz : oz + Z - 1]
        out.append(sl.reshape(3, -1))
    return out


def _scatter_rows(dims, acc):
    """acc: list of 8 [3, C] corner contributions -> [3,X,Y,Z] nodal
    sums (adjoint of _corner_rows: 8 padded adds, no scatter)."""
    X, Y, Z = dims
    out = None
    for b in range(8):
        if acc[b] is None:
            continue
        ox, oy, oz = (int(t) for t in T.CORNER_OFFSET[b])
        p = jnp.pad(
            acc[b].reshape(3, X - 1, Y - 1, Z - 1),
            [(0, 0), (ox, 1 - ox), (oy, 1 - oy), (oz, 1 - oz)],
        )
        out = p if out is None else out + p
    return out


def _ke_blockdiag(ke):
    """[6,12,12] per-tet element stiffness -> [72,72] block diagonal,
    so all six tets' stiffness applies run as ONE [72,72]x[72,C] matmul
    instead of six [12,12]x[12,C] ones (6x zero-padding FLOPs for one
    pass). Stays traced (ke carries the E_scale gradient on the
    differentiable path)."""
    z = jnp.zeros((6, 6, 12, 12), ke.dtype)
    z = z.at[jnp.arange(6), jnp.arange(6)].set(ke)
    return z.transpose(0, 2, 1, 3).reshape(72, 72)


def _tet_rows(corners, k):
    """[12, C] displacement/position rows of tet k (static corner picks)."""
    return jnp.concatenate(
        [corners[int(T.TET_CORNERS[k, j])] for j in range(4)], axis=0
    )


def _rot_rows(R, v12, transpose=False):
    """Apply blockdiag(R) (or R^T) to [12, C] given R [3, 3, C]:
    out[3j+a] = sum_b R[a,b] v[3j+b]   (R[b,a] when transpose).
    36 fused multiply-adds over [C] rows."""
    outs = []
    for j in range(4):
        for a in range(3):
            s = None
            for b in range(3):
                r = R[b, a] if transpose else R[a, b]
                t = r * v12[3 * j + b]
                s = t if s is None else s + t
            outs.append(s)
    return jnp.stack(outs, 0)


def _inv3_cm(m):
    """Inverse of a [3,3,C] matrix field via adjugate."""
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    rows = [
        [A, -(b * i - c * h), b * f - c * e],
        [B, a * i - c * g, -(a * f - c * d)],
        [C, -(a * h - b * g), a * e - b * d],
    ]
    return jnp.stack(
        [jnp.stack([rows[r][s] / det for s in range(3)], 0) for r in range(3)],
        0,
    )


def _det3_cm(m):
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    return (
        a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    )


def _polar_cm(F, iters=_POLAR_ITERS):
    """Rotation factor of a [3,3,C] matrix field (Higham iteration with
    det-sign fix — channel-major port of corotational.polar_rotation)."""
    det = _det3_cm(F)
    sign = jnp.where(det < 0, -1.0, 1.0)
    scale = jnp.sqrt(jnp.maximum(jnp.sum(F * F, (0, 1)) / 3.0, 1e-12))
    R = F / scale

    def body(_, R):
        Rit = jnp.swapaxes(_inv3_cm(R), 0, 1)
        return 0.5 * (R + Rit)

    R = jax.lax.fori_loop(0, iters, body, R)
    return R * sign


def kinematics(gf: GridFem, q: jax.Array) -> jax.Array:
    """Corotational rotations [6, 3, 3, C] from grid displacements q
    [X,Y,Z,3] (F = I + Du per Kuhn tet, polar decomposition). All 6 tet
    types are batched into one polar iteration along the channel axis."""
    corners = _corner_rows(gf.dims, _cm(q))
    Fs = []
    for k in range(6):
        du = _tet_rows(corners, k)                    # [12, C]
        # edges e = corner (e+1) minus corner 0, components a.
        # F[a,b] = I + sum_e Ds[a,e] inv_dm[e,b],  Ds[a,e] = du[3(e+1)+a]-du[a]
        rows = []
        for a in range(3):
            row = []
            for b in range(3):
                s = None
                for e in range(3):
                    t = (du[3 * (e + 1) + a] - du[a]) * gf.inv_dm[k, e, b]
                    s = t if s is None else s + t
                row.append(s + (1.0 if a == b else 0.0))
            rows.append(jnp.stack(row, 0))
        Fs.append(jnp.stack(rows, 0))                 # [3,3,C]
    F6 = jnp.concatenate(Fs, axis=-1)                 # [3,3,6C]
    R6 = _polar_cm(F6)
    C = Fs[0].shape[-1]
    return jnp.stack(
        [R6[..., k * C : (k + 1) * C] for k in range(6)], axis=0
    )


def _apply_tets(gf, R, corners, with_x0):
    """Shared per-tet channel-major pipeline:
      with_x0=True : f_e = R Ke (R^T (u + x0) - x0)   (internal forces)
      with_x0=False: f_e = R Ke R^T u                 (stiffness apply)
    corners: list of 8 [3, C]; returns [3,X,Y,Z]."""
    acc = [None] * 8
    cellw = gf.cellw
    rvs = []
    for k in range(6):
        v = _tet_rows(corners, k)                     # [12, C]
        if with_x0:
            v = v + gf.x0[k][:, None]
        rv = _rot_rows(R[k], v, transpose=True)
        if with_x0:
            rv = rv - gf.x0[k][:, None]
        rvs.append(rv)
    w72 = jnp.matmul(
        _ke_blockdiag(gf.ke), jnp.concatenate(rvs, 0), precision=_F32
    )                                                 # [72,72]x[72,C]
    for k in range(6):
        fw = _rot_rows(R[k], w72[12 * k : 12 * k + 12]) * cellw
        for j in range(4):
            b = int(T.TET_CORNERS[k, j])
            c = fw[3 * j : 3 * j + 3]
            acc[b] = c if acc[b] is None else acc[b] + c
    return _scatter_rows(gf.dims, acc)


def internal_forces(gf: GridFem, q: jax.Array, R: jax.Array) -> jax.Array:
    """Nodal internal forces [X,Y,Z,3]: f_e = R Ke (R^T p - x0) per tet,
    assembled by padded adds (fem.corotational.internal_forces on the
    dense grid)."""
    corners = _corner_rows(gf.dims, _cm(q))
    return _un_cm(_apply_tets(gf, R, corners, with_x0=True))


def stiffness_apply_rot(gf: GridFem, R: jax.Array, v: jax.Array):
    """Matrix-free K_rot v on the grid — the CG matvec. v [X,Y,Z,3]."""
    corners = _corner_rows(gf.dims, _cm(v))
    return _un_cm(_apply_tets(gf, R, corners, with_x0=False))


def _stiffness_apply_linear(dims, cellw, ke, v3):
    """Rest (R = I) stiffness apply — the multigrid level operator.
    v3 [3,X,Y,Z] -> [3,X,Y,Z]."""
    corners = _corner_rows(dims, v3)
    acc = [None] * 8
    v72 = jnp.concatenate(
        [_tet_rows(corners, k) for k in range(6)], 0
    )
    w72 = jnp.matmul(_ke_blockdiag(ke), v72, precision=_F32)
    for k in range(6):
        w = w72[12 * k : 12 * k + 12] * cellw
        for j in range(4):
            b = int(T.TET_CORNERS[k, j])
            c = w[3 * j : 3 * j + 3]
            acc[b] = c if acc[b] is None else acc[b] + c
    return _scatter_rows(dims, acc)


# ------------------------------------------------ multigrid transfer ops

def _prolong_axis(a: jax.Array, fine_n: int, axis: int) -> jax.Array:
    """Linear interpolation along one axis: coarse size nc -> fine size
    fine_n, fine 2i <- c[i], fine 2i+1 <- (c[i] + c[i+1]) / 2."""
    a = jnp.moveaxis(a, axis, 0)
    ne = (fine_n + 1) // 2          # even fine positions
    no = fine_n // 2                # odd fine positions
    even = a[:ne]
    odd = 0.5 * (a[:no] + a[1 : no + 1])
    if no < ne:                     # pad odd so interleave is rectangular
        odd = jnp.concatenate([odd, jnp.zeros_like(a[:1])], 0)
    out = jnp.stack([even, odd], axis=1).reshape(2 * ne, *a.shape[1:])
    return jnp.moveaxis(out[:fine_n], 0, axis)


def _restrict_axis(r: jax.Array, coarse_n: int, axis: int) -> jax.Array:
    """Adjoint of _prolong_axis (full weighting): fine size nf -> coarse
    size coarse_n, c[i] <- f[2i] + (f[2i-1] + f[2i+1]) / 2."""
    r = jnp.moveaxis(r, axis, 0)
    even = r[0::2]
    odd = r[1::2]
    zero = jnp.zeros_like(r[:1])

    def fit(x, n):
        if x.shape[0] < n:
            reps = jnp.broadcast_to(zero, (n - x.shape[0], *x.shape[1:]))
            return jnp.concatenate([x, reps], 0)
        return x[:n]

    out = fit(even, coarse_n)
    out = out + 0.5 * fit(odd, coarse_n)                       # f[2i+1]
    out = out + 0.5 * fit(jnp.concatenate([zero, odd], 0), coarse_n)
    return jnp.moveaxis(out, 0, axis)


def prolong(z: jax.Array, fine_dims) -> jax.Array:
    """[3, Xc, Yc, Zc] -> [3, X, Y, Z] trilinear prolongation."""
    for ax, n in enumerate(fine_dims):
        z = _prolong_axis(z, n, ax + 1)
    return z


def restrict(r: jax.Array, coarse_dims) -> jax.Array:
    """[3, X, Y, Z] -> [3, Xc, Yc, Zc], exact adjoint of prolong."""
    for ax, n in enumerate(coarse_dims):
        r = _restrict_axis(r, n, ax + 1)
    return r


# ------------------------------------------------------------ V-cycle

def _level_matvec(lvl: GridLevel, mc, sc, v3):
    free = lvl.free[None]
    vf = jnp.where(free, v3, 0.0)
    out = mc * lvl.mass[None] * vf + sc * _stiffness_apply_linear(
        lvl.dims, lvl.cellw, lvl.ke, vf
    )
    return jnp.where(free, out, v3)


def _level_inv_blocks(lvl: GridLevel, mc, sc):
    """[3,3,N] inverse diagonal blocks of the level operator."""
    mflat = lvl.mass.reshape(-1)
    eye = jnp.eye(3, dtype=mflat.dtype)[..., None]
    blocks = (mc * mflat) * eye + sc * lvl.kdiag
    freef = lvl.free.reshape(-1)[None, None]
    blocks = jnp.where(freef, blocks, eye)
    return _inv3_cm(blocks)


def _block_apply(inv_b, r3, dims):
    """inv_b [3,3,N] applied to r3 [3,X,Y,Z]."""
    r = r3.reshape(3, -1)
    out = jnp.stack(
        [
            inv_b[a, 0] * r[0] + inv_b[a, 1] * r[1] + inv_b[a, 2] * r[2]
            for a in range(3)
        ],
        0,
    )
    return out.reshape(r3.shape)


def _smooth(lvl, mc, sc, inv_b, r, z, sweeps):
    """Damped block-Jacobi iterations toward A z = r (fixed count, linear
    in r when started from z = 0 — keeps the V-cycle a linear operator)."""
    for _ in range(sweeps):
        resid = r - _level_matvec(lvl, mc, sc, z)
        z = z + _OMEGA * _block_apply(inv_b, resid, lvl.dims)
    return z


def mg_setup(levels: tuple[GridLevel, ...], mc, sc, coarse_inv=None):
    """Per-solve preconditioner setup (hoisted out of the per-CG-iteration
    V-cycle): smoother inverse blocks per level + the dense inverse of the
    coarsest-level operator (pass the host-precomputed GridFem.coarse_inv
    when the step uses the default coefficients)."""
    inv_bs = [_level_inv_blocks(l, mc, sc) for l in levels]
    coarse = levels[-1]
    if coarse_inv is None and coarse.k_dense is not None:
        mass3 = jnp.tile(coarse.mass.reshape(-1), 3)
        fr = coarse.free_dense
        a = sc * coarse.k_dense + jnp.diag(mc * mass3 * fr + (1.0 - fr))
        coarse_inv = jnp.linalg.inv(a)
    return inv_bs, coarse_inv


def vcycle(levels: tuple[GridLevel, ...], mc, sc, r: jax.Array,
           setup=None):
    """One symmetric V(1,1) multigrid cycle on the linear rest operator —
    the CG preconditioner — with a DIRECT dense solve on the coarsest
    level. Operates on [X,Y,Z,3] residuals. Fixed iteration counts and a
    fixed coarse inverse keep the map r -> z linear and symmetric."""
    if setup is None:
        setup = mg_setup(levels, mc, sc)
    inv_bs, coarse_inv = setup

    def cycle(i, r3):
        lvl = levels[i]
        free = lvl.free[None]
        r3 = jnp.where(free, r3, 0.0)
        if i == len(levels) - 1:
            if coarse_inv is not None:
                z = jnp.matmul(coarse_inv, r3.reshape(-1),
                               precision=_F32).reshape(r3.shape)
                return jnp.where(free, z, 0.0)
            z = jnp.zeros_like(r3)
            return _smooth(lvl, mc, sc, inv_bs[i], r3, z, 8)
        z = _smooth(lvl, mc, sc, inv_bs[i], r3, jnp.zeros_like(r3),
                    _NU_SMOOTH)
        resid = r3 - _level_matvec(lvl, mc, sc, z)
        rc = restrict(jnp.where(free, resid, 0.0), levels[i + 1].dims)
        zc = cycle(i + 1, rc)
        z = z + jnp.where(free, prolong(zc, lvl.dims), 0.0)
        return _smooth(lvl, mc, sc, inv_bs[i], r3, z, _NU_SMOOTH)

    return _un_cm(cycle(0, _cm(r)))


# ------------------------------------------------------------- builders

def _coarsen_masks(cell_mask: np.ndarray, fixed: np.ndarray):
    """(coarse cell mask, coarse fixed) from fine masks. Coarse cells
    cover 2x2x2 fine cells (any active -> active); coarse fixed is the
    coincident (even-index) fine vertex's flag."""
    X, Y, Z = (d + 1 for d in cell_mask.shape)
    Xc, Yc, Zc = X // 2 + 1, Y // 2 + 1, Z // 2 + 1
    cm = np.zeros((Xc - 1, Yc - 1, Zc - 1), bool)
    for ox in range(2):
        for oy in range(2):
            for oz in range(2):
                sub = cell_mask[ox::2, oy::2, oz::2]
                cm[: sub.shape[0], : sub.shape[1], : sub.shape[2]] |= sub
    fx = np.zeros((Xc, Yc, Zc), bool)
    sub = fixed[::2, ::2, ::2]
    fx[: sub.shape[0], : sub.shape[1], : sub.shape[2]] = sub
    return cm, fx


def _active_from_cells(cell_mask: np.ndarray) -> np.ndarray:
    """Vertex active mask: any incident active cell (extract_tet_mesh's
    node rule)."""
    X, Y, Z = (d + 1 for d in cell_mask.shape)
    pad = np.pad(cell_mask, 1)
    act = np.zeros((X, Y, Z), bool)
    for b in range(8):
        ox, oy, oz = (int(v) for v in T.CORNER_OFFSET[b])
        act |= pad[1 - ox : 1 - ox + X, 1 - oy : 1 - oy + Y,
                   1 - oz : 1 - oz + Z]
    return act


def _mass_grid(cell_mask: np.ndarray, cellsize: float, rho: float):
    X, Y, Z = (d + 1 for d in cell_mask.shape)
    cellm = cell_mask.astype(np.float64) * (rho * cellsize**3)
    pad = np.pad(cellm, 1)
    mass = np.zeros((X, Y, Z))
    for b in range(8):
        ox, oy, oz = (int(v) for v in T.CORNER_OFFSET[b])
        mass += _CORNER_MASS_W[b] * pad[
            1 - ox : 1 - ox + X, 1 - oy : 1 - oy + Y, 1 - oz : 1 - oz + Z
        ]
    return mass


def _kdiag_grid(cell_mask: np.ndarray, ke: np.ndarray):
    """[3,3,X*Y*Z] assembled linear diagonal blocks."""
    X, Y, Z = (d + 1 for d in cell_mask.shape)
    tab = _linear_diag_blocks_table(ke)                # [8,3,3]
    pad = np.pad(cell_mask.astype(np.float64), 1)
    out = np.zeros((X, Y, Z, 3, 3))
    for b in range(8):
        ox, oy, oz = (int(v) for v in T.CORNER_OFFSET[b])
        w = pad[1 - ox : 1 - ox + X, 1 - oy : 1 - oy + Y,
                1 - oz : 1 - oz + Z]
        out += w[..., None, None] * tab[b]
    return np.moveaxis(out.reshape(-1, 3, 3), 0, -1)


_DENSE_COARSE_MAX_DOF = 2048


def _assemble_dense(cell_mask: np.ndarray, ke: np.ndarray,
                    free: np.ndarray):
    """Dense assembled linear stiffness of one (small) level, fixed
    rows/cols zeroed. DOF ordering matches the channel-major flatten of
    [3, X, Y, Z]: dof = coord * n_verts + flat_vertex."""
    X, Y, Z = (d + 1 for d in cell_mask.shape)
    n = X * Y * Z
    K = np.zeros((3 * n, 3 * n))
    for ci, cj, ck in zip(*np.nonzero(cell_mask)):
        vids = []
        for b in range(8):
            ox, oy, oz = (int(v) for v in T.CORNER_OFFSET[b])
            vids.append((ci + ox) * Y * Z + (cj + oy) * Z + (ck + oz))
        for k in range(6):
            gdof = []
            for j in range(4):
                v = vids[T.TET_CORNERS[k, j]]
                gdof.extend(a * n + v for a in range(3))
            # local ke ordering is [corner j * 3 + coord a]
            K[np.ix_(gdof, gdof)] += ke[k]
    fr = free.reshape(-1)
    fd = np.concatenate([fr, fr, fr]).astype(np.float64)
    K = K * fd[:, None] * fd[None, :]
    return K, fd


def build_grid_fem(
    grid: GridSpec,
    cell_mask: np.ndarray,
    fixed: np.ndarray,
    E: float = DEFAULT_E,
    nu: float = DEFAULT_NU,
    rho: float = DEFAULT_RHO,
    n_levels: int = 4,
    dtype=jnp.float32,
) -> GridFem:
    """Host-side constructor. cell_mask [CX,CY,CZ] bool (TetMesh.cell_mask),
    fixed [X,Y,Z] bool grid-vertex anchors."""
    cell_mask = np.asarray(cell_mask, bool)
    fixed = np.asarray(fixed, bool)
    dims = tuple(d + 1 for d in cell_mask.shape)
    assert fixed.shape == dims, (fixed.shape, dims)

    ke, inv_dm, x0 = _kuhn_elements(grid.cellsize, E, nu)
    active = _active_from_cells(cell_mask)
    mass = _mass_grid(cell_mask, grid.cellsize, rho)
    kdiag = _kdiag_grid(cell_mask, ke)

    levels = []
    cm, fx, cs = cell_mask, fixed, grid.cellsize
    for li in range(n_levels):
        if li > 0:
            if min(d + 1 for d in cm.shape) <= 3:
                break
            cm, fx = _coarsen_masks(cm, fx)
            cs = cs * 2.0
        ke_l, _, _ = _kuhn_elements(cs, E, nu)
        act_l = _active_from_cells(cm)
        levels.append(
            GridLevel(
                cellw=jnp.asarray(cm.reshape(-1), dtype),
                free=jnp.asarray(act_l & ~fx),
                mass=jnp.asarray(_mass_grid(cm, cs, rho), dtype),
                ke=jnp.asarray(ke_l, dtype),
                kdiag=jnp.asarray(_kdiag_grid(cm, ke_l), dtype),
                dims=tuple(d + 1 for d in cm.shape),
            )
        )

    # Direct dense solve on the coarsest level (a [D,D] matmul beats
    # launch-bound smoother sweeps and is an exact coarse solve).
    coarse = levels[-1]
    d_coarse = 3 * int(np.prod(coarse.dims))
    coarse_inv = None
    mc0 = 1.0 + DEFAULT_TIMESTEP * DEFAULT_DAMPING_MASS
    sc0 = (DEFAULT_TIMESTEP * DEFAULT_DAMPING_STIFFNESS
           + DEFAULT_TIMESTEP * DEFAULT_TIMESTEP)
    if d_coarse <= _DENSE_COARSE_MAX_DOF:
        kd, fd = _assemble_dense(
            np.asarray(coarse.cellw, bool).reshape(
                tuple(d - 1 for d in coarse.dims)
            ),
            np.asarray(coarse.ke, np.float64),
            np.asarray(coarse.free),
        )
        levels[-1] = dataclasses.replace(
            coarse,
            k_dense=jnp.asarray(kd, dtype),
            free_dense=jnp.asarray(fd, dtype),
        )
        mass3 = np.tile(np.asarray(levels[-1].mass, np.float64).reshape(-1), 3)
        a = sc0 * kd + np.diag(mc0 * mass3 * fd + (1.0 - fd))
        coarse_inv = jnp.asarray(np.linalg.inv(a), dtype)

    return GridFem(
        cellw=jnp.asarray(cell_mask.reshape(-1), dtype),
        free=jnp.asarray(active & ~fixed),
        active=jnp.asarray(active),
        mass=jnp.asarray(mass, dtype),
        ke=jnp.asarray(ke, dtype),
        inv_dm=jnp.asarray(inv_dm, dtype),
        x0=jnp.asarray(x0.reshape(6, 12), dtype),
        kdiag=jnp.asarray(kdiag, dtype),
        levels=tuple(levels),
        coarse_inv=coarse_inv,
        coarse_coefs=(float(mc0), float(sc0)),
        origin=tuple(float(v) for v in grid.lo),
        dims=dims,
        cellsize=float(grid.cellsize),
    )


def node_to_grid_index(tm: TetMesh) -> np.ndarray:
    """[n_nodes] flat grid-vertex index per tet-mesh node id (the inverse
    of TetMesh.grid_to_node; node ids are flat-order ranks)."""
    g2n = np.asarray(tm.grid_to_node)
    return np.flatnonzero(g2n >= 0).astype(np.int32)


def grid_fem_from_tetmesh(
    grid: GridSpec,
    tm: TetMesh,
    fixed_nodes: np.ndarray | None = None,
    E: float = DEFAULT_E,
    nu: float = DEFAULT_NU,
    rho: float = DEFAULT_RHO,
    n_levels: int = 4,
) -> GridFem:
    """Build from an extracted TetMesh; fixed_nodes are tet-node ids (or a
    bool mask over nodes), translated onto the grid."""
    if tm.cell_mask is None:
        raise ValueError("TetMesh.cell_mask missing (re-extract the mesh)")
    cell_mask = np.asarray(tm.cell_mask)
    dims = tuple(d + 1 for d in cell_mask.shape)
    fixed = np.zeros(int(np.prod(dims)), bool)
    if fixed_nodes is not None:
        n2g = node_to_grid_index(tm)
        fixed_nodes = np.asarray(fixed_nodes)
        if fixed_nodes.dtype == bool:
            fixed_nodes = np.flatnonzero(fixed_nodes[: len(n2g)])
        fixed[n2g[fixed_nodes]] = True
    return build_grid_fem(
        grid, cell_mask, fixed.reshape(dims), E, nu, rho, n_levels
    )


# ------------------------------------------------------------- timestep

def timestep(
    gf: GridFem,
    state: FemState,
    f_ext: jax.Array,
    h: float = DEFAULT_TIMESTEP,
    damping_mass: float = DEFAULT_DAMPING_MASS,
    damping_stiffness: float = DEFAULT_DAMPING_STIFFNESS,
    cg_tol: float = CG_TOL,
    cg_max_iters: int = CG_MAX_ITERS,
    differentiable: bool = False,
    precond: str = "mg",
) -> tuple[FemState, jax.Array]:
    """One implicit Newmark step on the grid; mirrors
    fem.integrator.timestep (same K_eff, residual, warm start and
    custom_linear_solve semantics) with the stencil matvec and, by
    default, the multigrid preconditioner. f_ext is [X,Y,Z,3]."""
    free = gf.free[..., None]

    R = kinematics(gf, state.q)
    f_int = internal_forces(gf, state.q, R)
    m = gf.mass[..., None]

    kq = stiffness_apply_rot(gf, R, state.qvel)
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
        out = mass_coef * m * vf + stiff_coef * stiffness_apply_rot(
            gf, R, vf
        )
        return jnp.where(free, out, v)

    if precond == "mg" and gf.levels:
        pre_inv = None
        if (
            gf.coarse_inv is not None
            and abs(mass_coef - gf.coarse_coefs[0]) < 1e-12
            and abs(stiff_coef - gf.coarse_coefs[1]) < 1e-12
        ):
            pre_inv = gf.coarse_inv
        setup = mg_setup(gf.levels, mass_coef, stiff_coef, pre_inv)

        def prec(r):
            return vcycle(gf.levels, mass_coef, stiff_coef, r, setup)
    else:
        mflat = gf.mass.reshape(-1)
        eye = jnp.eye(3, dtype=residual.dtype)[..., None]
        blocks = (mass_coef * mflat) * eye + stiff_coef * gf.kdiag
        freef = gf.free.reshape(-1)[None, None]
        blocks = jnp.where(freef, blocks, eye)
        inv_blocks = _inv3_cm(blocks)

        def prec(r):
            return _un_cm(_block_apply(inv_blocks, _cm(r), gf.dims))

    if differentiable:
        dv = jax.lax.custom_linear_solve(
            matvec,
            residual,
            solve=lambda mv, b: pcg(mv, b, prec, cg_tol, cg_max_iters)[0],
            symmetric=True,
        )
        iters = jnp.asarray(-1, jnp.int32)
    else:
        x0 = None
        if state.dv is not None:
            x0 = jnp.where(free, state.dv, 0.0)
        dv, iters = pcg(matvec, residual, prec, cg_tol, cg_max_iters, x0=x0)

    qvel = jnp.where(free, state.qvel + dv, 0.0)
    q = jnp.where(free, state.q + h * qvel, 0.0)
    return FemState(q=q, qvel=qvel, dv=dv), iters
