"""Implicit integrator + matrix-free Jacobi-preconditioned CG.

Faithful port of the reference's default solver stack
(src/deformable/PS_VolumeConservingIntegrator.cpp:46-240 with the PCG
branch, vegafem/sparseSolver/CGSolver): per step

    K_eff = M + h (alpha M + beta K_rot) + h^2 K_rot
    residual = -h ((h + beta) K_rot qdot + alpha M qdot + f_int - f_ext)
    solve K_eff dv = residual   (Jacobi-PCG, tol 1e-6, <= 10k iters)
    qdot += dv;  q += h qdot;   fixed DOFs zeroed

Constrained DOFs are handled by projection (identity rows) instead of the
reference's RemoveRows/InsertRows repacking — same solution, static shapes.
Everything is matrix-free: K_rot v is the batched per-tet product from
fem.corotational, so no sparse matrix is ever materialized (the CG matvec
is the perf-critical kernel, mapped to batched 12x12 matmuls + segment-sum).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from . import corotational as co
from .tetmesh import FemMesh

# Reference integrator defaults (Deformable.cpp:208-216,
# PS_VolumeConservingIntegrator.cpp:17-28).
DEFAULT_TIMESTEP = 0.0333
DEFAULT_DAMPING_MASS = 0.0
DEFAULT_DAMPING_STIFFNESS = 0.01
CG_TOL = 1e-6
CG_MAX_ITERS = 10_000


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FemState:
    q: jax.Array      # [N, 3] displacements
    qvel: jax.Array   # [N, 3]
    # Previous step's velocity delta: the CG warm start (dv is h*accel,
    # which IS frame-coherent once the stopping threshold is measured
    # against |b| rather than the warm-started initial residual —
    # measuring vs r0 silently tightened the tolerance and made warm
    # starts look useless in round 1). None = cold start.
    dv: jax.Array | None = None

    @classmethod
    def rest(cls, mesh: FemMesh) -> "FemState":
        z = jnp.zeros_like(mesh.rest)
        # dv included so the pytree structure is identical to stepped
        # states (a None->array change retriggers jit compilation).
        return cls(q=z, qvel=z, dv=z)


def _vdot(a, b):
    """Full-precision f32 inner product (a default-precision dot may run
    in TF32 on a GPU)."""
    return jnp.vdot(a, b, precision=jax.lax.Precision.HIGHEST)


def pcg(matvec, b, prec, tol=CG_TOL, max_iters=CG_MAX_ITERS, x0=None):
    """Preconditioned conjugate gradients as a lax.while_loop.

    `prec` is either a diagonal array (Jacobi, the reference's default —
    vegafem CGSolver::SolveLinearSystemWithJacobiPreconditioner,
    sparseSolver/CGSolver.cpp:146-149) or a callable r -> M^-1 r (e.g.
    3x3 block-Jacobi). Stopping rule: M^-1-weighted residual norm z.r
    against tol^2 times the norm of b — the cold-start initial residual,
    so a warm start x0 reduces iterations instead of (as with an
    r0-relative rule) merely tightening the effective tolerance."""
    if not callable(prec):
        inv_diag = 1.0 / jnp.where(jnp.abs(prec) < 1e-30, 1.0, prec)
        prec = lambda r: r * inv_diag  # noqa: E731
    thresh = (tol * tol) * _vdot(b, prec(b))
    if x0 is None:
        x = jnp.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    z = prec(r)
    p = z
    rz = _vdot(r, z)

    def cond(s):
        x, r, p, rz, it = s
        return (rz > thresh) & (it < max_iters)

    def body(s):
        x, r, p, rz, it = s
        ap = matvec(p)
        alpha = rz / jnp.maximum(_vdot(p, ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new = _vdot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return (x, r, p, rz_new, it + 1)

    x, r, p, rz, it = jax.lax.while_loop(cond, body, (x, r, p, rz, 0))
    return x, it


def timestep(
    mesh: FemMesh,
    state: FemState,
    f_ext: jax.Array,
    h: float = DEFAULT_TIMESTEP,
    damping_mass: float = DEFAULT_DAMPING_MASS,
    damping_stiffness: float = DEFAULT_DAMPING_STIFFNESS,
    cg_tol: float = CG_TOL,
    cg_max_iters: int = CG_MAX_ITERS,
    differentiable: bool = False,
) -> tuple[FemState, jax.Array]:
    """One implicit step; returns (new_state, cg_iterations).

    With differentiable=True the CG solve is wrapped in
    `lax.custom_linear_solve` so reverse-mode gradients flow through the
    solve by the implicit function theorem (one adjoint solve) instead of
    unrolling CG iterations; the iteration count is then reported as -1.
    """
    free = ~mesh.fixed[:, None]  # [N,1] broadcast over xyz

    _, R = co.element_kinematics(mesh, state.q)
    f_int = co.internal_forces(mesh, state.q, R)
    m = mesh.mass[:, None]

    # R is constant across the CG solve: materialize R Ke R^T once so the
    # per-iteration matvec is a single batched 12x12 product.
    krot = co.rotated_stiffness(mesh, R)

    kq = co.stiffness_apply_pre(mesh, krot, state.qvel)
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
        out = mass_coef * m * vf + stiff_coef * co.stiffness_apply_pre(
            mesh, krot, vf
        )
        return jnp.where(free, out, v)

    # 3x3 block-Jacobi preconditioner: per-node diagonal blocks of K_eff,
    # inverted once per step (identity on fixed nodes, matching matvec's
    # identity rows there).
    eye = jnp.eye(3, dtype=residual.dtype)
    blocks = (mass_coef * m)[..., None] * eye + stiff_coef * (
        co.stiffness_blocks(mesh, krot)
    )
    blocks = jnp.where(free[..., None], blocks, eye)
    inv_blocks = co._inv3(blocks)

    def prec(r):
        return jnp.einsum("nab,nb->na", inv_blocks, r,
                          precision=jax.lax.Precision.HIGHEST)

    if differentiable:
        # No warm start here: custom_linear_solve reuses `solve` for the
        # adjoint system, where the primal guess would be wrong.
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
