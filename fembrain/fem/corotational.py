"""Corotational linear FEM: batched per-tet force/stiffness (Mueller 2004
warp, the reference default — vegafem corotationalLinearFEM.cpp:219-296
with warp=1) as pure vmapped array code.

Per tet: deformation gradient F = Ds * inv(Dm), rotation R by polar
decomposition (Higham iteration, differentiable, sign-fixed like the
reference's det<0 flip), internal force f_e = R Ke (R^T p - x0), and the
warped stiffness applied matrix-free: K_rot v = R Ke R^T v.
Nodal assembly is a segment-sum (deterministic — no atomics).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .tetmesh import FemMesh

# Every einsum that feeds the CG operator must run at full f32
# precision: a default-precision f32 matmul may run in TF32 on the GPU,
# and a reduced-precision multiply perturbs K_eff enough to break the
# operator's effective symmetry/definiteness, so CG diverges at
# production mesh sizes.
_F32 = jax.lax.Precision.HIGHEST


def _inv3(m):
    """Batched 3x3 inverse via adjugate (differentiable, no LU)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), b * f - c * e], -1),
            jnp.stack([B, a * i - c * g, -(a * f - c * d)], -1),
            jnp.stack([C, -(a * h - b * g), a * e - b * d], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def polar_rotation(F: jax.Array, iters: int = 12) -> jax.Array:
    """Rotation factor of batched 3x3 matrices via the Higham Newton
    iteration R <- (R + R^{-T}) / 2, with determinant sign fix (reference
    flips R when det < 0, corotationalLinearFEM.cpp:263-268)."""
    det = jnp.linalg.det(F)
    sign = jnp.where(det < 0, -1.0, 1.0)[..., None, None]
    # Normalize scale for fast convergence.
    scale = jnp.sqrt(jnp.maximum(jnp.sum(F * F, (-2, -1)) / 3.0, 1e-12))
    R = F / scale[..., None, None]

    def body(_, R):
        Rit = jnp.swapaxes(_inv3(R), -1, -2)
        return 0.5 * (R + Rit)

    R = jax.lax.fori_loop(0, iters, body, R)
    return R * sign


def element_kinematics(mesh: FemMesh, u: jax.Array):
    """u: [N, 3] displacements -> (p [T,4,3] deformed corners, R [T,3,3])."""
    x = mesh.rest + u
    p = x[mesh.tets]                                  # [T,4,3]
    ds = jnp.swapaxes(p[:, 1:] - p[:, :1], 1, 2)      # [T,3,3]
    F = jnp.einsum("tij,tjk->tik", ds, mesh.inv_dm, precision=_F32)
    return p, polar_rotation(F)


def internal_forces(mesh: FemMesh, u: jax.Array, R: jax.Array) -> jax.Array:
    """Nodal internal forces [N, 3]: f_e = R Ke (R^T p - x0) per element,
    segment-summed to nodes."""
    x = mesh.rest + u
    p = x[mesh.tets].reshape(-1, 12)                  # [T, 12]
    x0 = mesh.rest[mesh.tets].reshape(-1, 12)
    rp = _blockT_apply(R, p)                          # R^T p
    fe = _block_apply(R, _ke_apply(mesh.ke, rp - x0))  # R Ke (R^T p - x0)
    return _scatter_nodes(mesh, fe)


def stiffness_apply(mesh: FemMesh, R: jax.Array, v: jax.Array) -> jax.Array:
    """Matrix-free K_rot v for v [N,3]: per-element R Ke R^T, assembled."""
    ve = v[mesh.tets].reshape(-1, 12)
    we = _block_apply(R, _ke_apply(mesh.ke, _blockT_apply(R, ve)))
    return _scatter_nodes(mesh, we)


def rotated_stiffness(mesh: FemMesh, R: jax.Array) -> jax.Array:
    """Warped element stiffness K_rot = blockdiag(R) Ke blockdiag(R)^T,
    materialized [T,12,12]. R is constant across a CG solve, so computing
    this once per timestep turns the per-iteration matvec into a single
    batched 12x12 product (vs 3 einsums in stiffness_apply)."""
    keb = mesh.ke.reshape(-1, 4, 3, 4, 3)
    tmp = jnp.einsum("tap,tjpkq->tjakq", R, keb, precision=_F32)
    krot = jnp.einsum("tjakq,tbq->tjakb", tmp, R, precision=_F32)
    return krot.reshape(-1, 12, 12)


def stiffness_apply_pre(mesh: FemMesh, krot: jax.Array, v: jax.Array):
    """K_rot v using the precomputed per-element rotated stiffness."""
    ve = v[mesh.tets].reshape(-1, 12)
    return _scatter_nodes(mesh, _ke_apply(krot, ve))


def stiffness_blocks(mesh: FemMesh, krot: jax.Array) -> jax.Array:
    """Per-node 3x3 diagonal blocks of the assembled K_rot: [N,3,3].
    Feeds the block-Jacobi preconditioner (a strict upgrade over the
    reference's scalar Jacobi, vegafem sparseSolver/CGSolver.cpp)."""
    kb = krot.reshape(-1, 4, 3, 4, 3)
    corner = jnp.stack([kb[:, j, :, j, :] for j in range(4)], 1)  # [T,4,3,3]
    out = _scatter_nodes(mesh, corner.reshape(-1, 4, 9))
    return out.reshape(-1, 3, 3)


def stiffness_diag(mesh: FemMesh, R: jax.Array) -> jax.Array:
    """diag(K_rot) [N,3] for the Jacobi preconditioner:
    (R Ke R^T)[3j+a, 3j+a] = sum_bc R[a,b] Ke[3j+b, 3j+c] R[a,c]."""
    T = mesh.n_tets
    keb = mesh.ke.reshape(T, 4, 3, 4, 3)
    # only the j==j' corner blocks contribute to the diagonal
    kjj = jnp.stack([keb[:, j, :, j, :] for j in range(4)], 1)  # [T,4,3,3]
    d = jnp.einsum("tab,tjbc,tac->tja", R, kjj, R, precision=_F32)              # [T,4,3]
    return _scatter_nodes(mesh, d)


def _ke_apply(ke, v12):
    return jnp.einsum("tij,tj->ti", ke, v12, precision=_F32)


def _block_apply(R, v12):
    """Apply blockdiag(R,R,R,R) to [T,12]."""
    v = v12.reshape(-1, 4, 3)
    return jnp.einsum("tab,tjb->tja", R, v, precision=_F32).reshape(-1, 12)


def _blockT_apply(R, v12):
    v = v12.reshape(-1, 4, 3)
    return jnp.einsum("tba,tjb->tja", R, v, precision=_F32).reshape(-1, 12)


def _scatter_nodes(mesh: FemMesh, fe) -> jax.Array:
    """Element -> node assembly in gather form: pad the [T*4, W] slot
    array with one zero row, gather each node's incident slots
    (mesh.node_gather) and sum. Equivalent to an index-add scatter, with
    no atomics and a fixed summation order.
    Meshes without a gather map (shard-local tet partitions) scatter.
    fe may carry any trailing payload width W (3 for forces, 9 for the
    3x3 preconditioner blocks)."""
    slots = fe.reshape(mesh.tets.shape[0] * 4, -1)
    w = slots.shape[1]
    if mesh.node_gather is None:
        out = jnp.zeros((mesh.n_nodes, w), slots.dtype)
        return out.at[mesh.tets.reshape(-1)].add(slots)
    slots = jnp.concatenate([slots, jnp.zeros((1, w), slots.dtype)], 0)
    return jnp.sum(slots[mesh.node_gather], 1)
