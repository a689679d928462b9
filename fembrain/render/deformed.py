"""Coupled differentiable render+deform: sphere-trace the FEM-deformed
implicit field (BASELINE config #5 — the north-star path).

The reference couples FEM to rendering by adding nodal displacements to
cached rest-surface vertices on the GPU (`ApplyVertexDeformations`,
src/implicit/OclPolygonizer.cpp:1543-1596 +
data/opencl/Polygonizer.cl:1417-1426) — a mesh-space coupling that the
scene graph path here reproduces. For the differentiable tracer we couple
in FIELD space instead: the deformation map phi(x) = x + u(x) (u = FEM
nodal displacement, trilinearly interpolated on the polygonizer voxel
grid — the same embedding the tet extraction uses) turns the rest field f
into the deformed field

    F(y) = f(phi^{-1}(y)),

whose iso surface is exactly the deformed tissue surface. phi^{-1} is a
fixed-point iteration x <- y - u(x) (a contraction for |grad u| < 1, true
at soft-tissue strains), unrolled a few steps so everything is plainly
differentiable: image losses flow through the march's implicit hit
differentiation into BOTH the BlobTree primitive parameters (via f) and
the FEM state -> material parameters (via u and the implicit-diff
timestep). One jitted graph: force -> FEM solve -> displacement field ->
deformed image -> loss.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..blob.scene import Scene
from ..mesh.polygonize import GridSpec
from ..ops.field import field, field_and_color
from .sphere_trace import TraceParams, _ray_box

# Pull-back fixed-point iteration count. The inversion error is
# O(L^k |u|) per iteration; at soft-tissue strains (L ~ 0.1-0.3) the hit
# error is dominated by the RBF FIT error, not the inversion. k = 2 keeps
# a safety margin at larger L.
FIXED_POINT_ITERS = 2

# All interpolant matmuls run at full f32 precision: a default-precision
# f32 matmul may run in TF32 (about three decimal digits) on the GPU,
# which corrupts the E-gradient through the ill-conditioned kernel
# inverse a_inv (FD misses it: its systematic error cancels across the
# stencil).
_HI = jax.lax.Precision.HIGHEST


def displacement_grid(grid: GridSpec, grid_to_node: jax.Array,
                      u: jax.Array) -> jax.Array:
    """Scatter FEM nodal displacements onto the voxel grid: [X, Y, Z, 3].

    Grid vertices that are not tet nodes (outside the inside/crossed cell
    set) get zero displacement; every cell the iso surface passes through
    has all 8 corners as tet nodes (mesh.polygonize.extract_tet_mesh marks
    inside+crossed cells), so interpolation near the surface uses real
    nodal values only."""
    safe = jnp.maximum(grid_to_node, 0)
    ug = jnp.where((grid_to_node >= 0)[:, None], u[safe], 0.0)
    X, Y, Z = grid.dims
    return ug.reshape(X, Y, Z, 3)


def sample_displacement(grid: GridSpec, u_grid: jax.Array,
                        pts: jax.Array) -> jax.Array:
    """Trilinear displacement sample at world points [N, 3] -> [N, 3].
    Clamps to the grid (zero-displacement padding outside the mesh)."""
    X, Y, Z = grid.dims
    origin = jnp.asarray(grid.lo, pts.dtype)
    rel = (pts - origin) / grid.cellsize
    dims = jnp.asarray([X, Y, Z], pts.dtype)
    rel = jnp.clip(rel, 0.0, dims - 1.0 - 1e-6)
    i0 = jnp.floor(rel).astype(jnp.int32)
    i0 = jnp.minimum(i0, jnp.asarray([X - 2, Y - 2, Z - 2], jnp.int32))
    fr = rel - i0

    def corner(dx, dy, dz):
        return u_grid[i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz]

    wx = fr[:, 0:1]
    wy = fr[:, 1:2]
    wz = fr[:, 2:3]
    c00 = corner(0, 0, 0) * (1 - wz) + corner(0, 0, 1) * wz
    c01 = corner(0, 1, 0) * (1 - wz) + corner(0, 1, 1) * wz
    c10 = corner(1, 0, 0) * (1 - wz) + corner(1, 0, 1) * wz
    c11 = corner(1, 1, 0) * (1 - wz) + corner(1, 1, 1) * wz
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wx) + c1 * wx


def pull_back(grid: GridSpec, u_grid: jax.Array, y: jax.Array,
              iters: int = FIXED_POINT_ITERS) -> jax.Array:
    """Invert phi(x) = x + u(x): fixed-point x <- y - u(x), unrolled so
    the inverse map is differentiable through plain autodiff."""
    x = y
    for _ in range(iters):
        x = y - sample_displacement(grid, u_grid, x)
    return x


def deformed_field(scene: Scene, grid: GridSpec, u_grid: jax.Array,
                   y: jax.Array) -> jax.Array:
    """F(y) = f(phi^{-1}(y)) — the implicit field of the deformed tissue."""
    return field(scene, pull_back(grid, u_grid, y))


def trace_deformed(scene: Scene, grid: GridSpec, u_grid: jax.Array,
                   ro: jax.Array, rd: jax.Array,
                   params: TraceParams = TraceParams(),
                   max_disp: float = 0.5):
    """Sphere-trace the deformed field. Fixed-step march (the Wyvill
    support bound does not survive an arbitrary warp), slab bracket
    expanded by `max_disp` so the deformed surface stays inside. Returns
    (t_hit, hit_mask), differentiable via implicit hit differentiation."""
    iso = params.iso
    lo = scene.bbox_lo - 0.05 - max_disp
    hi = scene.bbox_hi + 0.05 + max_disp
    t_enter, t_exit = _ray_box(ro, rd, lo[None], hi[None])
    alive0 = t_exit > t_enter
    t_enter = jnp.where(alive0, t_enter, 0.0)
    t_exit = jnp.where(alive0, t_exit, 0.0)

    diag = jnp.linalg.norm(hi - lo)
    base_step = diag * params.step_frac

    def eval_f(t):
        return deformed_field(scene, grid, u_grid, ro + t[:, None] * rd) - iso

    f0 = eval_f(t_enter)
    state = dict(
        t=t_enter, f=f0, t_prev=t_enter, f_prev=f0,
        found=(f0 >= 0.0) & alive0,
        alive=alive0 & (f0 < 0.0),
        it=jnp.zeros((), jnp.int32),
    )

    def cond(s):
        return (s["it"] < params.max_steps) & jnp.any(s["alive"])

    def body(s):
        t_new = jnp.minimum(s["t"] + base_step, t_exit)
        f_new = eval_f(t_new)
        crossed = s["alive"] & (f_new >= 0.0)
        done = s["alive"] & (t_new >= t_exit) & (f_new < 0.0)
        return dict(
            t=jnp.where(s["alive"], t_new, s["t"]),
            f=jnp.where(s["alive"], f_new, s["f"]),
            t_prev=jnp.where(s["alive"], s["t"], s["t_prev"]),
            f_prev=jnp.where(s["alive"], s["f"], s["f_prev"]),
            found=s["found"] | crossed,
            alive=s["alive"] & ~crossed & ~done,
            it=s["it"] + 1,
        )

    s = jax.lax.while_loop(cond, body, state)
    found = s["found"]

    def bis_body(_, st):
        a, b, fa, fb = st
        m = 0.5 * (a + b)
        fm = eval_f(m)
        neg = fm < 0.0
        return (
            jnp.where(neg, m, a), jnp.where(neg, b, m),
            jnp.where(neg, fm, fa), jnp.where(neg, fb, fm),
        )

    a, b, fa, fb = jax.lax.fori_loop(
        0, params.bisect_steps, bis_body,
        (s["t_prev"], s["t"], s["f_prev"], s["f"]),
    )
    denom = fb - fa
    t_sec = a - fa * (b - a) / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    t_root = jnp.where(jnp.abs(denom) < 1e-9, 0.5 * (a + b), t_sec)
    t_root = jnp.where(found, t_root, t_exit)

    # Implicit differentiation of F(ro + t rd) = iso at the root.
    t0 = jax.lax.stop_gradient(t_root)
    x0 = ro + t0[:, None] * rd

    def f_point(p):
        return deformed_field(scene, grid, u_grid, p[None])[0]

    g = jax.vmap(jax.grad(f_point))(x0)
    dfdt = jnp.sum(g * rd, -1)
    dfdt = jax.lax.stop_gradient(
        jnp.where(jnp.abs(dfdt) < 1e-6, jnp.where(dfdt < 0, -1e-6, 1e-6), dfdt)
    )
    f_at = deformed_field(scene, grid, u_grid, x0) - iso
    t_hit = t0 - jnp.clip(f_at / dfdt, -0.5 * base_step, 0.5 * base_step)
    t_hit = jnp.where(found, t_hit, t_exit)
    return t_hit, found


def shade_deformed(scene: Scene, grid: GridSpec, u_grid: jax.Array,
                   ro, rd, t_hit, hit_mask,
                   light_dir=(0.577, 0.577, 0.577),
                   background=(1.0, 1.0, 1.0),
                   material=None, texture=None,
                   texture_scale: float = 1.0):
    """Blinn-Phong shading of the deformed surface: normals from the
    deformed field's autodiff gradient (exact normals of the warped
    surface), material color sampled at the pulled-back rest point.
    `material` selects shading parameters (graphics.materials);
    `texture` ([H, W, 3] jnp image) modulates the albedo by triplanar
    sampling at the REST point, so the pattern sticks to the deforming
    tissue."""
    if material is None:
        from ..graphics.materials import PHONG as material
    x = ro + t_hit[:, None] * rd

    def f_point(p):
        return deformed_field(scene, grid, u_grid, p[None])[0]

    g = jax.vmap(jax.grad(f_point))(x)
    n = -g * jax.lax.rsqrt(
        jnp.maximum(jnp.sum(g * g, -1, keepdims=True), 1e-24)
    )
    x_rest = pull_back(grid, u_grid, x)
    _, col = field_and_color(scene, x_rest)
    if texture is not None:
        from ..graphics.materials import triplanar_sample_jax

        col = col.at[:, :3].mul(
            triplanar_sample_jax(texture, x_rest, n, texture_scale)
        )
    ldir = jnp.asarray(light_dir)
    ldir = ldir / jnp.linalg.norm(ldir)
    ndotl = jnp.maximum(jnp.sum(n * ldir, -1), 0.0)
    h = ldir - rd
    h = h / jnp.linalg.norm(h, axis=-1, keepdims=True)
    spec = jnp.maximum(jnp.sum(n * h, -1), 0.0) ** material.shininess
    rgb = (
        col[:, :3]
        * (material.ambient + material.diffuse * ndotl)[:, None]
        + material.specular * spec[:, None]
    )
    bg = jnp.asarray(background)
    return jnp.where(hit_mask[:, None], rgb, bg[None])


@partial(jax.jit, static_argnames=("grid", "width", "height", "params"))
def render_deformed(scene: Scene, grid: GridSpec, grid_to_node: jax.Array,
                    u: jax.Array, cam, width: int, height: int,
                    params: TraceParams = TraceParams()) -> jax.Array:
    """[H, W, 3] image of the tissue displaced by FEM state u [N, 3]."""
    from .camera import generate_rays

    ro, rd = generate_rays(cam, width, height)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    u_grid = displacement_grid(grid, grid_to_node, u)
    t, hit = trace_deformed(scene, grid, u_grid, ro, rd, params)
    rgb = shade_deformed(scene, grid, u_grid, ro, rd, t, hit)
    return rgb.reshape(height, width, 3)


# --------------------------------------------------------------------------
# Fast coupled path: RBF-interpolated displacement field.
#
# The exact trilinear embedding above costs ~32 grid gathers per field
# evaluation (8 corners x 4 fixed-point iterations). The reference's own
# answer to "query the field after deformation" is FastRBF
# (src/implicit/RBF.h:51-136). Here the RBF interpolates the DISPLACEMENT
# u(x) from a static subset of FEM nodes: the saddle system is factored
# once per mesh (static A_inv), so per-frame weights are one matmul —
# linear and differentiable in the FEM state q — and evaluation is a
# distance computation + matvec with no gathers; the compact-support
# (Wendland) kind lets the trace kernel cull center blocks.
# --------------------------------------------------------------------------

DISP_CENTERS = 128

# Wendland support radius as a multiple of the center fill distance
# (centers are farthest-point sampled, so fill ~ center spacing): small
# enough that per-tile center culling bites, large enough that the
# interpolant stays smooth between centers (fidelity pinned by tests).
WENDLAND_SIGMA_FILL = 3.0
# max_t |d/dt (1-t)^4 (4t+1)| = 20 t (1-t)^3 at t = 1/4.
WENDLAND_DPHI_MAX = 2.109375


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DispInterp:
    """Static displacement-interpolation operator for one FEM mesh.

    kind="biharmonic": u = sum_k w_k |x - c_k| + a + B x  (reference
    FastRBF analog, src/implicit/RBF.h:81-84 — global support).
    kind="wendland":   u = sum_k w_k phi(|x - c_k| / sigma) + a + B x with
    the Wendland C2 kernel phi(t) = (1-t)^4 (4t+1) on [0,1] — COMPACT
    support, the production coupled-trace kernel: center contributions
    are exactly zero beyond sigma, so the Pallas march culls center
    blocks per tile like prim blocks and the per-tile Lipschitz/max|u|
    march bounds come only from live blocks (SAMPLED at the centers by
    default — accurate, heuristic between samples; rigorous weight-sum
    bounds via wendland_pallas_spec(certified=True))."""
    centers: jax.Array       # [M, 3] world positions of the chosen nodes
    center_nodes: jax.Array  # [M] int32 FEM node ids
    a_inv: jax.Array         # [M+4, M+4] inverse of the kernel saddle
                             #   system [[phi, P], [P^T, 0]], P = [1, x]
    fill_dist: jax.Array     # [] farthest node-to-nearest-center distance
                             #   (feeds max_disp_bound telemetry)
    kind: str = dataclasses.field(
        metadata=dict(static=True), default="biharmonic"
    )
    sigma: float = dataclasses.field(
        metadata=dict(static=True), default=0.0
    )


def _phi_dist(interp: DispInterp, d: jax.Array) -> jax.Array:
    """Kernel value from distance(s) d (any shape)."""
    if interp.kind == "biharmonic":
        return d
    t = jnp.minimum(d * (1.0 / interp.sigma), 1.0)
    omt = 1.0 - t
    o2 = omt * omt
    return o2 * o2 * (4.0 * t + 1.0)


def _dphi_over_d(interp: DispInterp, d: jax.Array) -> jax.Array:
    """(d phi / d r) / r evaluated at distance d — the radial-gradient
    factor: grad_x phi(|x-c|) = _dphi_over_d * (x - c). Finite at 0 for
    wendland; biharmonic uses 1/d (callers guard d > 0)."""
    if interp.kind == "biharmonic":
        return 1.0 / jnp.maximum(d, 1e-12)
    s = 1.0 / interp.sigma
    t = jnp.minimum(d * s, 1.0)
    omt = 1.0 - t
    # dphi/dt = -20 t (1-t)^3; dphi/dr / r = dphi/dt * s / d
    #         = -20 (1-t)^3 s^2   (t = d s, so t/d = s)
    return -20.0 * omt * omt * omt * (s * s)


def _kernel_lipschitz_coef(interp: DispInterp) -> float:
    """max_r |d phi / d r|: 1 for biharmonic, 2.109/sigma for wendland."""
    if interp.kind == "biharmonic":
        return 1.0
    return WENDLAND_DPHI_MAX / interp.sigma


def adaptive_centers(n_nodes: int) -> int:
    """Center count scaled to mesh size: ~cbrt growth so the center
    spacing tracks the node spacing (u is smooth at the elastic length
    scale, not the node scale), clamped to [64, 512] and rounded to a
    multiple of 8 for kernel-friendly shapes. 128 (the round-2 fixed
    default) at ~14k nodes, 256 at ~110k, capped 512 at ~900k."""
    import math

    m = int(16 * round(n_nodes ** (1.0 / 3.0) / 3.0))
    return max(64, min(512, (m + 7) // 8 * 8))


def _morton_order(pts) -> "np.ndarray":
    """Permutation sorting points by the Morton code of their positions —
    spatially-close points land in the same contiguous block (mirrors
    pallas_trace._additive_layout for prims)."""
    import numpy as np

    pts = np.asarray(pts, np.float64)
    lo = pts.min(0)
    span = np.maximum(pts.max(0) - lo, 1e-9)
    q = np.clip((pts - lo) / span * 1023.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )
    return np.argsort(code, kind="stable")


def _factor_interp(c, kind: str, sigma: float) -> "np.ndarray":
    """Inverse of the interpolation system for centers c [M, 3]
    (float64 host math), embedded in the uniform [M+4, M+4] layout.

    biharmonic: the saddle system [[phi, P], [P^T, 0]] — |x-c| is only
    conditionally positive definite, so the polynomial tail is required.
    wendland: the kernel is POSITIVE DEFINITE, so the plain phi system
    is well-posed WITHOUT a polynomial tail — and dropping it is what
    makes the interpolant EXACTLY ZERO beyond sigma of every center
    (an affine tail has global support and would force every deformed
    march step everywhere in the scene to pay displacement slack; with
    w[m:] = 0 the Pallas march is certified pull-free and full-speed
    wherever no center block is live — see pallas_trace step_ctrl).
    The affine rows of the inverse are zero so downstream layouts
    ([M+4, 3] weights with w[m:] as the affine part) are unchanged."""
    import numpy as np

    m = len(c)
    d = np.linalg.norm(c[:, None] - c[None], axis=-1)
    a = np.zeros((m + 4, m + 4))
    if kind == "biharmonic":
        phi = d
        p = np.concatenate([np.ones((m, 1)), c], 1)  # [M, 4]
        a[:m, :m] = phi + 1e-9 * np.eye(m)
        a[:m, m:] = p
        a[m:, :m] = p.T
        return np.linalg.inv(a)
    t = np.minimum(d / sigma, 1.0)
    phi = (1.0 - t) ** 4 * (4.0 * t + 1.0)
    a[:m, :m] = np.linalg.inv(phi + 1e-9 * np.eye(m))
    return a


def build_disp_interp(nodes, n_centers: int | None = None,
                      fixed=None, kernel: str = "biharmonic",
                      sigma_fill: float = WENDLAND_SIGMA_FILL,
                      extra_centers=None, sigma: float | None = None,
                      ) -> DispInterp:
    """Farthest-point-sample `n_centers` FEM nodes and factor the kernel
    interpolation system (host-side, once per mesh topology).
    n_centers=None picks adaptive_centers(len(nodes)). Including fixed
    nodes pins u = 0 at anchors automatically (their q rows are zero).

    kernel="wendland" builds the compact-support production interpolant
    (support sigma = sigma_fill * fill distance); centers are then
    Morton-ordered so the Pallas kernel's 8-center cull blocks are
    spatially tight. extra_centers: node ids appended after the FPS pick
    (error-driven refinement, see refine_disp_interp)."""
    import numpy as np

    nodes = np.asarray(nodes, np.float64)
    n = len(nodes)
    if n_centers is None:
        n_centers = adaptive_centers(n)
    m = min(n_centers, n)
    # Farthest-point sampling for even coverage.
    sel = [0]
    d = np.linalg.norm(nodes - nodes[0], axis=-1)
    for _ in range(m - 1):
        i = int(np.argmax(d))
        sel.append(i)
        d = np.minimum(d, np.linalg.norm(nodes - nodes[i], axis=-1))
    if extra_centers is not None:
        for i in np.asarray(extra_centers).tolist():
            if i not in sel:
                sel.append(int(i))
                d = np.minimum(
                    d, np.linalg.norm(nodes - nodes[int(i)], axis=-1)
                )
    idx = np.asarray(sel, np.int64)
    fill = float(np.max(d))
    if kernel != "biharmonic":
        idx = idx[_morton_order(nodes[idx])]
    c = nodes[idx]
    if sigma is None:
        # Support scale: the fill distance, floored by the median
        # nearest-center spacing (fill collapses to 0 when every node is
        # a center — e.g. tiny test meshes). Refinement passes an
        # explicit sigma so locally-densified centers keep the base
        # support radius.
        pair = np.linalg.norm(c[:, None] - c[None], axis=-1)
        np.fill_diagonal(pair, np.inf)
        spacing = float(np.median(pair.min(1))) if len(c) > 1 else 1.0
        sigma = sigma_fill * max(fill, spacing, 1e-6)
    a_inv = _factor_interp(c, kernel, sigma)
    return DispInterp(
        centers=jnp.asarray(c, jnp.float32),
        center_nodes=jnp.asarray(idx, jnp.int32),
        a_inv=jnp.asarray(a_inv, jnp.float32),
        fill_dist=jnp.asarray(fill, jnp.float32),
        kind=kernel,
        sigma=float(sigma),
    )


def refine_disp_interp(interp: DispInterp, nodes, u,
                       n_extra: int = 64, batch: int = 8,
                       fixed=None) -> DispInterp:
    """ERROR-DRIVEN center refinement (reference FastRBF greedily adds
    centers to fitting accuracy, src/implicit/RBF.h:81-84
    — it refines by error, not geometry): given a representative
    displacement sample `u` [N, 3] at `nodes` (e.g. the settled FEM sag,
    or post-cut state), repeatedly fit, rank the per-node residual
    |u - u_interp|, and add the worst-fit nodes as new centers (batch at
    a time, spaced at least half the local center spacing so a single
    bad region doesn't soak up the whole budget). The kernel support
    sigma stays the BASE interp's — refinement densifies locally without
    shrinking the global support scale. Host-side, once per topology or
    after a settle/cut."""
    import numpy as np

    nodes = np.asarray(nodes, np.float64)
    u = np.asarray(u, np.float64)
    idx = list(np.asarray(interp.center_nodes))
    sigma = float(interp.sigma) if interp.kind != "biharmonic" else None
    for _ in range(-(-n_extra // batch)):
        c = nodes[idx]
        a_inv = _factor_interp(
            c, interp.kind,
            sigma if sigma is not None else 1.0,
        )
        rhs = np.concatenate([u[idx], np.zeros((4, 3))], 0)
        w = a_inv @ rhs
        d = np.linalg.norm(nodes[:, None] - c[None], axis=-1)
        if interp.kind == "biharmonic":
            phi = d
        else:
            t = np.minimum(d / sigma, 1.0)
            phi = (1.0 - t) ** 4 * (4.0 * t + 1.0)
        uh = phi @ w[: len(idx)] + w[len(idx)] + nodes @ w[len(idx) + 1:]
        resid = np.linalg.norm(uh - u, axis=-1)
        resid[idx] = 0.0
        min_sep = 0.5 * float(np.median(np.sort(d, axis=1)[:, 0] + 1e-9))
        order = np.argsort(-resid)
        added = []
        for j in order:
            if len(added) >= batch or resid[j] <= 0:
                break
            if all(
                np.linalg.norm(nodes[j] - nodes[k]) > min_sep
                for k in added
            ):
                added.append(int(j))
        if not added:
            break
        idx.extend(added)
        if len(idx) >= len(interp.center_nodes) + n_extra:
            break
    base_m = len(np.asarray(interp.center_nodes))
    return build_disp_interp(
        nodes, n_centers=base_m, fixed=fixed, kernel=interp.kind,
        sigma=sigma, extra_centers=idx[base_m:],
    )


def disp_weights_centers(interp: DispInterp, u_c: jax.Array):
    """RBF weights from displacements AT the centers: [M+4, 3] =
    A_inv @ rhs. Linear in u_c, so gradients flow through."""
    rhs = jnp.concatenate([u_c, jnp.zeros((4, 3), u_c.dtype)], 0)
    return jnp.matmul(interp.a_inv, rhs, precision=_HI)  # [M+4, 3]


def disp_weights(interp: DispInterp, q: jax.Array):
    """Per-frame RBF weights from the FEM state: [M+4, 3] = A_inv @ rhs.
    Linear in q, so gradients flow through to material parameters."""
    u_c = q[interp.center_nodes]                      # [M, 3] (one gather
    return disp_weights_centers(interp, u_c)          # of M rows)


def sample_disp_rbf(interp: DispInterp, w: jax.Array,
                    pts: jax.Array) -> jax.Array:
    """u(x) = sum_k w_k phi(|x - c_k|) + a + B x  at [N, 3] points
    (dense — the correctness/fallback path; the Pallas kernel culls)."""
    m = interp.centers.shape[0]
    d = jnp.sqrt(jnp.maximum(
        jnp.sum((pts[:, None] - interp.centers[None]) ** 2, -1), 1e-24
    ))                                                # [N, M]
    u = jnp.matmul(_phi_dist(interp, d), w[:m], precision=_HI)
    u = u + w[m] + jnp.matmul(pts, w[m + 1:], precision=_HI)
    return u


def disp_lipschitz(interp: DispInterp, w: jax.Array) -> jax.Array:
    """Upper bound on |grad u|: each phi(|x-c_k|) is Lipschitz with
    constant max|dphi/dr| (1 for biharmonic, 2.109/sigma for wendland),
    so L <= coef * sum_k |w_k|_2 + |B|_F. A traced scalar (used in step
    sizes only, never in control flow)."""
    m = interp.centers.shape[0]
    return (
        _kernel_lipschitz_coef(interp)
        * jnp.sum(jnp.sqrt(jnp.sum(w[:m] ** 2, -1)))
        + jnp.sqrt(jnp.sum(w[m + 1:] ** 2))
    )


def disp_slack(interp: DispInterp, w: jax.Array) -> jax.Array:
    """2 * (bound on max |u| over the tissue): u interpolates its center
    values exactly, so max|u| <= max_j |u(c_j)| + L * fill_dist. Feeds
    the subtractive deformed-march step bound d - slack, which beats the
    multiplicative (1 - L) d in the far field where the global Lipschitz
    bound L is loose (see pallas_trace._march_tile)."""
    u_c = sample_disp_rbf(interp, w, interp.centers)
    return 2.0 * (
        jnp.max(jnp.sqrt(jnp.sum(u_c ** 2, -1)))
        + disp_lipschitz(interp, w) * interp.fill_dist
    )


def disp_bounds_sampled(interp: DispInterp, w: jax.Array,
                        pts: jax.Array,
                        l_safety: float = 1.25,
                        u_safety: float = 1.15):
    """(shrink, slack) march-step factors from DENSE SAMPLING of the
    interpolant at `pts` (mesh nodes, ~cellsize spacing).

    The certified global bounds (disp_lipschitz / disp_slack) assume all
    center gradients align — on real fits sum|w_k| lands at L > 1 while
    the true max|grad u| is ~0.1, which zeroes the adaptive march
    and slows the march to fixed steps.
    Here L and max|u| are measured at the sample points: exact there,
    extended between samples by the safety factors (u is smooth at the
    elastic length scale, far coarser than the node spacing; fidelity is
    pinned by tests against the exact trilinear-embedding tracer)."""
    m = interp.centers.shape[0]
    diff = pts[:, None] - interp.centers[None]        # [N, M, 3]
    d = jnp.sqrt(jnp.maximum(jnp.sum(diff ** 2, -1), 1e-24))
    u = (jnp.matmul(_phi_dist(interp, d), w[:m], precision=_HI)
         + w[m] + jnp.matmul(pts, w[m + 1:], precision=_HI))  # [N, 3]
    # grad u[a, b] = sum_k (dphi/dr / r) diff[n, k, a] w_k[b] + B[a, b]
    g = jnp.einsum(
        "nka,kb->nab", diff * _dphi_over_d(interp, d)[..., None], w[:m],
        precision=_HI,
    ) + w[m + 1:]
    l_max = jnp.sqrt(jnp.max(jnp.sum(g ** 2, (-2, -1))))   # Frobenius
    u_max = jnp.sqrt(jnp.max(jnp.sum(u ** 2, -1)))
    shrink = jnp.clip(1.0 - l_safety * l_max, 0.0, 1.0)
    slack = 2.0 * u_safety * u_max
    return (
        jax.lax.stop_gradient(shrink),
        jax.lax.stop_gradient(slack),
    )


def wendland_pallas_spec(interp: DispInterp, w: jax.Array,
                         max_disp=None, fp_iters: int = 1,
                         certified: bool = False, k_refresh: int = 0):
    """Per-frame Pallas displacement spec for the wendland kernel path:
    centers padded to a CEN_BLOCK multiple (pad rows at 1e6 with zero
    weights never test live), plus the per-block march-bound inputs.

    certified=False (default): bu/bg are |u| and |grad u| SAMPLED at
    the centers and extended between samples by the march's 1.15/1.25
    safety factors — accurate and tight, but a heuristic: |u| between
    centers can in principle exceed the factored sample maxima (ADVICE
    r4 #2). certified=True: bu/bg are rigorous per-block bounds — for
    block b, every point within reach of b's support region satisfies
    |u(x)| <= sum over blocks b' whose support overlaps b's reach of
    sum_{k in b'} |w_k| (phi <= 1), and |grad u| likewise with the
    kernel slope bound — loose (no cancellation), so marches slow down,
    but the step bounds then hold unconditionally."""
    from .pallas_trace import CEN_BLOCK, WendlandDisp

    m = interp.centers.shape[0]
    mp = -(-m // CEN_BLOCK) * CEN_BLOCK
    cen = jnp.concatenate(
        [interp.centers, jnp.full((mp - m, 3), 1e6, jnp.float32)], 0
    ) if mp > m else interp.centers
    wk = w[:m].astype(jnp.float32)                    # [M, 3]
    wr = jnp.concatenate(
        [wk, jnp.zeros((mp - m, 3), jnp.float32)], 0
    ) if mp > m else wk
    waff = w[m:].T.astype(jnp.float32)                # [3, 4]
    c = interp.centers
    if certified:
        # Rigorous per-block bounds from weight sums: |w| rows grouped
        # per block, summed over every block within 2*sigma (a point in
        # b's sigma-reach can see centers one more sigma away).
        wn = jnp.sqrt(jnp.sum(wk * wk, -1))           # [M]
        if mp > m:
            wn_p = jnp.concatenate([wn, jnp.zeros(mp - m)], 0)
            cen_p = cen
        else:
            wn_p, cen_p = wn, c
        blk_sum = wn_p.reshape(-1, CEN_BLOCK).sum(1)  # [NBc]
        cb = cen_p.reshape(-1, CEN_BLOCK, 3)
        b_lo = cb.min(1)
        b_hi = cb.max(1)
        reach = 2.0 * interp.sigma
        near = jnp.all(
            (b_lo[:, None] <= b_hi[None] + reach)
            & (b_hi[:, None] >= b_lo[None] - reach), -1
        )                                             # [NBc, NBc]
        bu = near @ blk_sum                           # sum over near
        bg = (WENDLAND_DPHI_MAX / interp.sigma) * bu
        # (the tail-free interpolant has no affine part; if one exists
        #  the caller's aff bound adds on top via bfr below)
    else:
        # Per-block SAMPLED march-bound inputs: |u| and |grad u|
        # evaluated exactly AT the centers ([M, M] dense — ~1 MFLOP per
        # frame). The weight-sum bounds above are rigorous but loose
        # (neighboring-center cancellation is the norm: sum|w| can give
        # L > 1 where the true max |grad u| is ~0.1, which zeroes the
        # adaptive march); sampling at the centers is exact there and the
        # per-tile bounds extend between samples with the
        # disp_bounds_sampled safety factors.
        diff = c[:, None] - c[None]                   # [M, M, 3]
        d = jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, -1), 1e-24))
        u_c = (jnp.matmul(_phi_dist(interp, d), wk, precision=_HI)
               + w[m] + jnp.matmul(c, w[m + 1:], precision=_HI))
        g_c = jnp.einsum(
            "jka,kb->jab", diff * _dphi_over_d(interp, d)[..., None], wk,
            precision=_HI,
        ) + w[m + 1:]
        un = jnp.sqrt(jnp.sum(u_c * u_c, -1))         # [M]
        gn = jnp.sqrt(jnp.sum(g_c * g_c, (-2, -1)))   # [M] Frobenius
        if mp > m:
            un = jnp.concatenate([un, jnp.zeros(mp - m)], 0)
            gn = jnp.concatenate([gn, jnp.zeros(mp - m)], 0)
        bu = un.reshape(-1, CEN_BLOCK).max(1)         # [NBc]
        bg = gn.reshape(-1, CEN_BLOCK).max(1)
    bfr = jnp.sqrt(jnp.sum(w[m + 1:] ** 2))
    if max_disp is None:
        if certified:
            max_disp = jnp.max(bu)
        else:
            # Per-frame displacement bound: max over centers (u
            # interpolates there) extended by the same between-sample
            # safety the march bounds use, + the Lipschitz fill term
            # (max_disp_bound scheme).
            max_disp = (
                1.15 * jnp.max(bu) + jnp.max(bg) * interp.fill_dist
            )
    return WendlandDisp(
        centers=cen, w=wr, waff=waff,
        bu=jax.lax.stop_gradient(bu), bg=jax.lax.stop_gradient(bg),
        bfr=jax.lax.stop_gradient(bfr),
        max_disp=jax.lax.stop_gradient(
            jnp.asarray(max_disp, jnp.float32)
        ),
        sigma=float(interp.sigma),
        fp_iters=int(fp_iters),
        k_refresh=int(k_refresh),
    )


def pull_back_rbf(interp: DispInterp, w: jax.Array, y: jax.Array,
                  iters: int = FIXED_POINT_ITERS) -> jax.Array:
    """Invert phi(x) = x + u(x) with u from the RBF interpolant."""
    x = y
    for _ in range(iters):
        x = y - sample_disp_rbf(interp, w, x)
    return x


def deformed_field_rbf(scene: Scene, interp: DispInterp, w: jax.Array,
                       y: jax.Array,
                       iters: int = FIXED_POINT_ITERS) -> jax.Array:
    return field(scene, pull_back_rbf(interp, w, y, iters))


def trace_deformed_rbf(scene: Scene, interp: DispInterp, w: jax.Array,
                       ro: jax.Array, rd: jax.Array,
                       params: TraceParams = TraceParams(),
                       max_disp: float = 0.5,
                       fp_iters: int = FIXED_POINT_ITERS,
                       bound_pts: jax.Array | None = None):
    """Sphere-trace the RBF-deformed field with ADAPTIVE stepping.

    The rest-field support bound r(f) maps through phi: |phi(a) - phi(b)|
    >= (1 - L)|a - b| for displacement Lipschitz constant L < 1, so a
    conservative world step in deformed space is the rest-space step
    scaled by (1 - L). L is a traced per-frame scalar (disp_lipschitz),
    clamped so pathological fits degrade to fixed stepping, not misses.
    """
    from .sphere_trace import support_radius_bound

    from .sphere_trace import prim_interval

    iso = params.iso
    lo = scene.bbox_lo - 0.05 - max_disp
    hi = scene.bbox_hi + 0.05 + max_disp
    if scene.can_cull:
        # Deformed support: phi moves points at most max_disp, so the
        # rest-field support boxes inflated by max_disp bound the
        # deformed field's support — tight per-ray brackets + dead-ray
        # culling survive deformation.
        t_enter, t_exit, alive0 = prim_interval(
            scene, ro, rd, margin=0.05 + max_disp
        )
    else:
        t_enter, t_exit = _ray_box(ro, rd, lo[None], hi[None])
        alive0 = t_exit > t_enter
        t_enter = jnp.where(alive0, t_enter, 0.0)
        t_exit = jnp.where(alive0, t_exit, 0.0)

    diag = jnp.linalg.norm(hi - lo)
    base_step = diag * params.step_frac
    r_iso = jnp.sqrt(1.0 - iso ** (1.0 / 3.0))
    adaptive = scene.monotone_field
    inv_stretch = 1.0 / max(scene.max_world_to_local_scale, 1e-6)
    if bound_pts is not None:
        shrink, slack = disp_bounds_sampled(interp, w, bound_pts)
    else:
        shrink = jnp.clip(
            1.0 - jax.lax.stop_gradient(disp_lipschitz(interp, w)), 0.0, 1.0
        )
        slack = jax.lax.stop_gradient(disp_slack(interp, w))

    def eval_f(t):
        return deformed_field_rbf(
            scene, interp, w, ro + t[:, None] * rd, fp_iters
        ) - iso

    def step_size(f):
        if not adaptive:
            return base_step
        r = support_radius_bound(f)
        d = (r - r_iso) * inv_stretch
        # Max of the two sound deformed-space bounds (see
        # pallas_trace._march_tile): (1-L) d and d - 2 max|u|.
        return jnp.maximum(
            base_step, 0.95 * jnp.maximum(shrink * d, d - slack)
        )

    f0 = eval_f(t_enter)
    state = dict(
        t=t_enter, f=f0, t_prev=t_enter, f_prev=f0,
        found=(f0 >= 0.0) & alive0,
        alive=alive0 & (f0 < 0.0),
        it=jnp.zeros((), jnp.int32),
    )

    def cond(s):
        return (s["it"] < params.max_steps) & jnp.any(s["alive"])

    def body(s):
        t_new = jnp.minimum(s["t"] + step_size(s["f"] + iso), t_exit)
        f_new = eval_f(t_new)
        crossed = s["alive"] & (f_new >= 0.0)
        done = s["alive"] & (t_new >= t_exit) & (f_new < 0.0)
        return dict(
            t=jnp.where(s["alive"], t_new, s["t"]),
            f=jnp.where(s["alive"], f_new, s["f"]),
            t_prev=jnp.where(s["alive"], s["t"], s["t_prev"]),
            f_prev=jnp.where(s["alive"], s["f"], s["f_prev"]),
            found=s["found"] | crossed,
            alive=s["alive"] & ~crossed & ~done,
            it=s["it"] + 1,
        )

    s = jax.lax.while_loop(cond, body, state)
    found = s["found"]

    def bis_body(_, st):
        a, b, fa, fb = st
        m = 0.5 * (a + b)
        fm = eval_f(m)
        neg = fm < 0.0
        return (
            jnp.where(neg, m, a), jnp.where(neg, b, m),
            jnp.where(neg, fm, fa), jnp.where(neg, fb, fm),
        )

    a, b, fa, fb = jax.lax.fori_loop(
        0, params.bisect_steps, bis_body,
        (s["t_prev"], s["t"], s["f_prev"], s["f"]),
    )
    denom = fb - fa
    t_sec = a - fa * (b - a) / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    t_root = jnp.where(jnp.abs(denom) < 1e-9, 0.5 * (a + b), t_sec)
    t_root = jnp.where(found, t_root, t_exit)

    # Implicit differentiation at the root (same scheme as trace_deformed).
    t0 = jax.lax.stop_gradient(t_root)
    x0 = ro + t0[:, None] * rd

    def f_point(p):
        return deformed_field_rbf(scene, interp, w, p[None], fp_iters)[0]

    g = jax.vmap(jax.grad(f_point))(x0)
    dfdt = jnp.sum(g * rd, -1)
    dfdt = jax.lax.stop_gradient(
        jnp.where(jnp.abs(dfdt) < 1e-6, jnp.where(dfdt < 0, -1e-6, 1e-6), dfdt)
    )
    f_at = deformed_field_rbf(scene, interp, w, x0, fp_iters) - iso
    t_hit = t0 - jnp.clip(f_at / dfdt, -0.5 * base_step, 0.5 * base_step)
    t_hit = jnp.where(found, t_hit, t_exit)
    return t_hit, found


def _implicit_hit_correction(scene: Scene, interp: DispInterp, w, ro, rd,
                             t_root, found, params: TraceParams,
                             max_disp: float, fp_iters: int):
    """Differentiable hit parameter around a forward-only root: one
    Newton step of F(ro + t rd) = iso against the XLA deformed field, so
    dt/dtheta = -F_theta / (grad F . rd) exactly as in trace_deformed_rbf."""
    lo = scene.bbox_lo - 0.05 - max_disp
    hi = scene.bbox_hi + 0.05 + max_disp
    base_step = jnp.linalg.norm(hi - lo) * params.step_frac
    t0 = jax.lax.stop_gradient(t_root)
    x0 = ro + t0[:, None] * rd

    def f_point(p):
        return deformed_field_rbf(scene, interp, w, p[None], fp_iters)[0]

    g = jax.vmap(jax.grad(f_point))(x0)
    dfdt = jnp.sum(g * rd, -1)
    dfdt = jax.lax.stop_gradient(
        jnp.where(jnp.abs(dfdt) < 1e-6, jnp.where(dfdt < 0, -1e-6, 1e-6), dfdt)
    )
    f_at = deformed_field_rbf(scene, interp, w, x0, fp_iters) - params.iso
    nudge = jnp.clip(f_at / dfdt, -0.5 * base_step, 0.5 * base_step)
    return jnp.where(found, t0 - nudge, t0)


def frame_max_disp(interp: DispInterp, w: jax.Array, max_disp=None):
    """The bracket inflation both deformed-trace paths use: an explicit
    bound when given; else THIS frame's |u| bound for the Wendland
    interpolant (wendland_pallas_spec's sampled bound), so brackets and
    cull boxes grow only as far as the frame's displacement requires;
    else the static 0.5 (biharmonic)."""
    if max_disp is not None:
        return max_disp
    if interp.kind == "wendland":
        return wendland_pallas_spec(interp, jax.lax.stop_gradient(w)).max_disp
    return 0.5


def trace_deformed_rbf_fast(scene: Scene, interp: DispInterp, w: jax.Array,
                            ro: jax.Array, rd: jax.Array,
                            params: TraceParams = TraceParams(),
                            max_disp: float | None = None,
                            image_hw: tuple[int, int] | None = None,
                            interpret: bool = False,
                            fp_iters: int = FIXED_POINT_ITERS,
                            need_grads: bool = True,
                            bound_pts: jax.Array | None = None,
                            k_refresh: int = 0,
                            use_pallas: bool | None = None):
    """RBF-deformed sphere trace on the path render.pallas_trace.
    select_trace_path picks: the trace kernel on the GPU (or in interpret
    mode when a test asks), trace_deformed_rbf otherwise. use_pallas=False
    forces the XLA tracer; use_pallas=True demands the kernel and raises
    where it cannot run.

    On the kernel path the march pulls points back through the Wendland
    interpolant inside the kernel (warm-started fixed-point iterations
    with per-tile center-block culling; render.pallas_trace). The kernel
    output carries a zero cotangent, and with need_grads the
    differentiable implicit-hit correction is applied outside against the
    XLA deformed field, so gradients equal trace_deformed_rbf's.
    image_hw enables the block-coherent pixel permutation for row-major
    H x W ray grids. Biharmonic interpolants always take the XLA tracer.
    max_disp: see frame_max_disp (both paths bracket alike)."""
    from .pallas_trace import (
        select_trace_path, trace_pallas, trace_pallas_image, zero_cotangent,
    )

    path = select_trace_path(scene, deformed=interp.kind, interpret=interpret)
    if use_pallas and not path.kernel:
        raise ValueError(f"trace kernel unavailable: {path.reason}")
    max_disp = frame_max_disp(interp, w, max_disp)
    if use_pallas is False or not path.kernel:
        return trace_deformed_rbf(scene, interp, w, ro, rd, params, max_disp,
                                  fp_iters, bound_pts=bound_pts)
    def raw(scene_, w_, ro_, rd_):
        # One fixed-point iteration per eval: the kernel warm-starts each
        # pull-back from the lane's carried rest point, so the iteration
        # converges across the march.
        disp = wendland_pallas_spec(
            interp, jax.lax.stop_gradient(w_), max_disp, 1,
            k_refresh=k_refresh,
        )
        if image_hw is not None:
            return trace_pallas_image(
                scene_, ro_, rd_, image_hw[0], image_hw[1], params,
                interpret=path.interpret, disp=disp,
            )
        return trace_pallas(scene_, ro_, rd_, params,
                            interpret=path.interpret, disp=disp)

    t_root, found = zero_cotangent(raw)(scene, w, ro, rd)
    if not need_grads:
        # Forward rendering: the kernel already bisects + secants the root
        # against the deformed field, so the correction buys nothing.
        return t_root, found
    t_hit = _implicit_hit_correction(scene, interp, w, ro, rd, t_root, found,
                                     params, max_disp, fp_iters)
    return t_hit, found


def coupled_step_fast(scene: Scene, fem_mesh, interp: DispInterp,
                      state, f_ext: jax.Array,
                      ro: jax.Array, rd: jax.Array,
                      h: float = 0.0333,
                      E_scale: jax.Array | float = 1.0,
                      params: TraceParams = TraceParams(),
                      image_hw: tuple[int, int] | None = None,
                      use_pallas: bool | None = None,
                      differentiable: bool = False,
                      cg_tol: float | None = None,
                      max_disp: float | None = None,
                      fp_iters: int = FIXED_POINT_ITERS,
                      bound_pts: jax.Array | None = None,
                      k_refresh: int = 0):
    """North-star step on the fast path: force -> implicit FEM solve ->
    RBF displacement weights (one matmul) -> adaptive deformed trace.
    Same differentiable structure as coupled_step; the displacement field
    is the RBF interpolant instead of the trilinear grid embedding.

    differentiable=False (the forward/rendering default) uses the
    warm-started PCG solver (state.dv carries the previous step's velocity
    delta — frame-coherent, so steady-state frames converge in a handful
    of CG iterations). Set differentiable=True for training steps: the
    solve is then wrapped in `custom_linear_solve` so image-loss gradients
    reach E_scale and the BlobTree through one adjoint solve (no warm
    start — the adjoint reuses the same solver where a primal guess would
    be wrong). cg_tol=None keeps the solver default (1e-6). The trace
    path comes from render.pallas_trace.select_trace_path (use_pallas:
    see trace_deformed_rbf_fast). max_disp inflates the ray
    brackets / cull boxes so the deformed surface stays inside
    (frame_max_disp); it must upper-bound the actual |u| (checked by
    max_disp_bound telemetry)."""
    from ..fem import integrator as integ

    mesh2 = dataclasses.replace(fem_mesh, ke=fem_mesh.ke * E_scale)
    kw = {} if cg_tol is None else {"cg_tol": cg_tol}
    new_state, _ = integ.timestep(
        mesh2, state, f_ext, h=h, differentiable=differentiable, **kw
    )
    w = disp_weights(interp, new_state.q)
    t, hit = trace_deformed_rbf_fast(
        scene, interp, w, ro, rd, params, max_disp=max_disp,
        image_hw=image_hw, fp_iters=fp_iters, need_grads=differentiable,
        bound_pts=bound_pts, k_refresh=k_refresh, use_pallas=use_pallas,
    )
    return t, hit, new_state


def coupled_step_grid_fast(scene: Scene, gf, interp: DispInterp,
                           center_grid_idx: jax.Array,
                           state, f_ext: jax.Array,
                           ro: jax.Array, rd: jax.Array,
                           h: float = 0.0333,
                           E_scale: jax.Array | float = 1.0,
                           params: TraceParams = TraceParams(),
                           image_hw: tuple[int, int] | None = None,
                           use_pallas: bool | None = None,
                           interpret: bool = False,
                           differentiable: bool = False,
                           cg_tol: float | None = None,
                           max_disp: float | None = None,
                           fp_iters: int = FIXED_POINT_ITERS,
                           bound_pts: jax.Array | None = None,
                           k_refresh: int = 0):
    """North-star step on the GRID-FEM fast path: the production coupled
    frame. Same structure as coupled_step_fast, but the implicit solve is
    fem.grid_fem.timestep (stencil matvec + multigrid preconditioner).
    `gf` is a fem.grid_fem.GridFem, `state` a grid FemState ([X,Y,Z,3]
    leaves), f_ext is [X,Y,Z,3], and `center_grid_idx` [M] maps interp
    centers to flat grid vertices (node_to_grid_index(tm)[interp.
    center_nodes]). The trace path comes from render.pallas_trace.
    select_trace_path (use_pallas / interpret: see
    trace_deformed_rbf_fast)."""
    from ..fem import grid_fem as gfm

    gf2 = gf if E_scale is None else dataclasses.replace(
        gf, ke=gf.ke * E_scale
    )
    kw = {} if cg_tol is None else {"cg_tol": cg_tol}
    new_state, _ = gfm.timestep(
        gf2, state, f_ext, h=h, differentiable=differentiable, **kw
    )
    u_c = new_state.q.reshape(-1, 3)[center_grid_idx]   # [M,3] tiny gather
    w = disp_weights_centers(interp, u_c)
    t, hit = trace_deformed_rbf_fast(
        scene, interp, w, ro, rd, params, max_disp=max_disp,
        image_hw=image_hw, interpret=interpret, fp_iters=fp_iters,
        need_grads=differentiable, bound_pts=bound_pts, k_refresh=k_refresh,
        use_pallas=use_pallas,
    )
    return t, hit, new_state


def max_disp_bound(interp: DispInterp, w: jax.Array,
                   q: jax.Array) -> jax.Array:
    """Per-frame upper bound on |u(x)| over the tissue region:
    u interpolates q exactly at the centers, and |u(x) - u(c_j)| <=
    L |x - c_j| for the nearest center c_j, so over the mesh node cloud

        max |u| <= max_j |u(c_j)| + L * fill_dist,

    with fill_dist the static farthest node-to-nearest-center distance
    (precomputed in build_disp_interp) and L = disp_lipschitz(w). Cheap
    traced telemetry for asserting the coupled path's static `max_disp`
    inflation actually bounds the frame's displacements (ADVICE r2 #4)."""
    u_c = jnp.sqrt(jnp.sum(q[interp.center_nodes] ** 2, -1))
    return jnp.max(u_c) + disp_lipschitz(interp, w) * interp.fill_dist


def coupling_telemetry(interp: DispInterp, w: jax.Array,
                       q: jax.Array) -> dict:
    """Per-frame coupling health (VERDICT r2 #7): the displacement
    Lipschitz bound L, the adaptive-march shrink factor clamp(1-L) (0
    means the trace silently degraded to fixed stepping), and the
    max-|u| bound that must stay under the static max_disp inflation.
    All traced scalars — log them, don't branch on them."""
    L = disp_lipschitz(interp, w)
    # q: full nodal state [N,3], or already-gathered center rows [M,3].
    u = q if q.shape[0] == interp.centers.shape[0] else (
        q[interp.center_nodes]
    )
    u_c = jnp.sqrt(jnp.sum(u ** 2, -1))
    return {
        "disp_lipschitz": L,
        "march_shrink": jnp.clip(1.0 - L, 0.0, 1.0),
        "max_disp_bound": jnp.max(u_c) + L * interp.fill_dist,
    }


def coupled_step(scene: Scene, fem_mesh, grid: GridSpec,
                 grid_to_node: jax.Array, state, f_ext: jax.Array,
                 ro: jax.Array, rd: jax.Array,
                 h: float = 0.0333,
                 E_scale: jax.Array | float = 1.0,
                 params: TraceParams = TraceParams()):
    """The north-star step: ONE differentiable graph
    force -> implicit FEM solve -> displacement field -> deformed trace.

    Returns (t_hit, hit_mask, new_state). E_scale scales the Young's
    modulus (element stiffness is linear in E for fixed nu), so
    d(image loss)/d(E_scale) is the material gradient; gradients also
    reach the BlobTree primitive parameters through the rest field.
    Matches the per-frame coupling of the reference
    (OclPolygonizer.cpp:1543-1596) but differentiably, in field space."""
    from ..fem import integrator as integ

    mesh2 = dataclasses.replace(fem_mesh, ke=fem_mesh.ke * E_scale)
    new_state, _ = integ.timestep(
        mesh2, state, f_ext, h=h, differentiable=True
    )
    u_grid = displacement_grid(grid, grid_to_node, new_state.q)
    t, hit = trace_deformed(scene, grid, u_grid, ro, rd, params)
    return t, hit, new_state
