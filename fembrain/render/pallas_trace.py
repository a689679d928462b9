"""Sphere-tracing kernel for NVIDIA GPUs (Pallas, Triton route).

The XLA tracer (render.sphere_trace.trace) marches every ray in lock-step:
each march step is a pass over the whole ray state in device memory, and
the loop stops only when the last ray is done. This kernel gives each
program one tile of T rays. The tile marches in registers with its own
early exit, and a tile whose rays are all done stops evaluating the field.

Layout: one program per tile, per-ray state as [T] vectors (T a power of
two). Scene parameters are scalar loads from small row-major tables (one
primitive or RBF center per row; a few KB that stay in L1/L2). A block of
primitives adds its fields into the [T] accumulator one row at a time, so
no matrix product and no [P, T] plane is ever formed. Every culling
decision (the per-tile live masks computed in XLA, and the per-eval ray
hull tested against block boxes) is a scalar uniform across the program,
so a culled block is a branch that costs no divergence.

The kernel is forward-only: implicit differentiation of the hit parameter
happens outside (one field + gradient eval at the root), so gradients are
exactly those of the XLA path. `select_trace_path` is the one place that
decides between this kernel and the XLA reference tracer.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial, reduce

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..blob.scene import Scene
from ..blob.types import OpType
from ..ops.field import field, gradient, rows_prim_fields, supports_rows_fast_path
from ..ops.warp import warp_components
from .sphere_trace import TraceParams, _ray_box, prim_interval, support_radius_bound
from .sphere_trace import trace as trace_xla

TILE = 256        # rays per program (a power of two); with NUM_WARPS,
NUM_WARPS = 4     # the fastest of T in {128, 256, 512} x {4, 8} warps on
                  # the H100 for the deformed trace, within 10% for the
                  # rest trace (PERF.md)
PRIM_BLOCK = 8    # prims per cull block (blob.scene._normalize_additive)
K_REFRESH = 8     # deformed-march evals between pull-back refreshes (the
                  # per-lane linear rest-point model rides in between;
                  # staleness is certified into the step slack)
CEN_BLOCK = 32    # RBF centers per cull block (Wendland deformed trace):
                  # Morton blocks small enough to stay spatially tight for
                  # the per-eval hull cull.
GENERIC_MAX_PRIMS = 64  # the non-additive kernel evaluates every prim
                        # per step; larger scenes take the XLA tracer

_ROW = 8          # per-tile row: inv_stretch, shrink, slack, drift L, base_step
_PRIM_COLS = 32   # prim table row: mtx (12), pos (3), dir (3), res (4), type
_CEN_COLS = 8     # center table row: center (3), weight (3)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class WendlandDisp:
    """Compact-support displacement spec for the deformed kernel trace.

    The Wendland interpolant (render.deformed, kind="wendland") has
    exactly-zero center contributions beyond `sigma`, so the kernel culls
    CEN_BLOCK-center Morton blocks per tile exactly like prim blocks:
    per-eval cost scales with the local center density instead of the
    total center count M. Built per frame by
    render.deformed.wendland_pallas_spec."""
    centers: jax.Array   # [Mp, 3] Morton-blocked center rows (pad 1e6)
    w: jax.Array         # [Mp, 3] per-frame kernel weights (pad 0)
    waff: jax.Array      # [3, 4] affine tail (col 0 constant, 1:4 B^T)
    bu: jax.Array        # [NBc] per-block max_j |u(c_j)|
    bg: jax.Array        # [NBc] per-block max_j |grad u(c_j)|_F sampled
                         #   AT the centers (exact there; extended between
                         #   samples by the march-bound safety factors)
    bfr: jax.Array       # [] Frobenius norm of the affine linear part B
    max_disp: jax.Array = None  # [] traced per-frame |u| bound: inflates
                         #   brackets/support boxes only as much as THIS
                         #   frame's displacement requires
    sigma: float = dataclasses.field(metadata=dict(static=True), default=1.0)
    fp_iters: int = dataclasses.field(metadata=dict(static=True), default=1)
    k_refresh: int = dataclasses.field(metadata=dict(static=True), default=0)
    # k_refresh: evals per refresh cycle in the march schedule
    # (0 = module default K_REFRESH); higher-curvature displacement
    # fields may prefer shorter cycles.


# --------------------------------------------------------------------------
# Path selection
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TracePath:
    """Which tracer runs a trace, and why. kernel=False is the XLA
    reference tracer (render.sphere_trace / render.deformed)."""
    kernel: bool
    interpret: bool
    reason: str


def kernel_supports(scene: Scene, deformed: bool = False) -> bool:
    """Whether the kernel covers this scene: additive scenes (the culled
    block path, the only one that traces deformed fields), or small
    non-additive scenes whose fold unrolls (the generic path)."""
    additive = scene.is_additive and scene.capacity_prims % PRIM_BLOCK == 0
    if deformed:
        return additive
    return additive or (supports_rows_fast_path(scene)
                        and scene.n_prims <= GENERIC_MAX_PRIMS)


def select_trace_path(scene: Scene, deformed: str | None = None,
                      interpret: bool = False) -> TracePath:
    """The trace path for `scene` on the default backend.

    deformed: None for a rest trace, else the displacement interpolant's
    kind ("wendland" or "biharmonic"). On the GPU the kernel runs,
    compiled through Triton; on the CPU the XLA reference runs, unless a
    test asks for the kernel in interpret mode. Scenes outside the kernel
    and biharmonic interpolants take the XLA tracer on every platform.
    Any other platform is an error."""
    if deformed == "biharmonic":
        return TracePath(False, False, "biharmonic interpolant: XLA tracer")
    if not kernel_supports(scene, deformed is not None):
        return TracePath(False, False, "scene outside the kernel: XLA tracer")
    if interpret:
        return TracePath(True, True, "kernel in interpret mode")
    platform = jax.default_backend()
    if platform == "gpu":
        return TracePath(True, False, "kernel compiled for the GPU")
    if platform == "cpu":
        return TracePath(False, False, "cpu: XLA reference tracer")
    raise RuntimeError(f"no trace path for platform {platform!r}")


# --------------------------------------------------------------------------
# In-kernel march
# --------------------------------------------------------------------------

def _hull(mask, px, py, pz):
    """Box around the points of the masked lanes (empty: lo > hi)."""
    return tuple(
        f(jnp.where(mask, p, s)) for p in (px, py, pz)
        for f, s in ((jnp.min, 1e30), (jnp.max, -1e30))
    )


def _box_live(hull, box_ref, b):
    """Scalar: does the hull overlap row b of a [NB, 8] box table
    (lo xyz, hi xyz)?"""
    x0, x1, y0, y1, z0, z1 = hull
    return (
        (x0 <= box_ref[b, 3] + 1e-4) & (x1 >= box_ref[b, 0] - 1e-4)
        & (y0 <= box_ref[b, 4] + 1e-4) & (y1 >= box_ref[b, 1] - 1e-4)
        & (z0 <= box_ref[b, 5] + 1e-4) & (z1 >= box_ref[b, 2] - 1e-4)
    )


def _prim_field(prm, p, px, py, pz, types):
    """Wyvill field of prim row p (scalar loads) at [T] points."""
    m = [prm[p, k] for k in range(12)]
    vt = tuple(
        m[4 * i] * px + m[4 * i + 1] * py + m[4 * i + 2] * pz + m[4 * i + 3]
        for i in range(3)
    )
    pos = tuple(prm[p, 12 + i] for i in range(3))
    dirv = tuple(prm[p, 15 + i] for i in range(3))
    res = tuple(prm[p, 18 + i] for i in range(4))
    return rows_prim_fields(vt, pos, dirv, res, prm[p, 22], types)


def _march(evaluate, params: TraceParams, adaptive: bool, row,
           t_enter, t_exit, alive0, carry0, deformed: bool, k_cycle: int):
    """Sphere-trace one tile's [T] rays to the iso crossing with tile-local
    early exit, then refine the bracket. Returns (t_root, found).

    evaluate(t, carry, refresh, mask, keep) -> (field - iso, carry'):
    `refresh` (Python or traced scalar bool) asks the deformed path for a
    true pull-back; `mask` selects the lanes whose field value is used and
    `keep` the lanes whose carried rest point must stay exact (the hull
    culls run over those lanes only). Rest traces ignore `refresh` and
    `keep`.

    Deformed marches take the safe deformed-space step from TWO sound
    under-bounds of the rest-space support distance d, after subtracting
    the linear model's certified staleness eps = 2 L |t - t_refresh|:
      multiplicative  (1 - L)(d - eps)      (Lipschitz contraction), and
      subtractive     (d - eps) - 2 max|u|  (|phi(a)-phi(b)| >=
                                             |a-b| - |u(a)| - |u(b)|).
    Tiles with no live center block have L = slack = 0 and march at
    exact rest speed."""
    iso = params.iso
    r_iso = math.sqrt(1.0 - iso ** (1.0 / 3.0))
    inv_stretch, shrink, slack, ldrift, base_step = (row[k] for k in range(5))

    def run_tile(_):
        started = alive0 > 0.0
        f0, car = evaluate(t_enter, carry0, True, started, started)
        state = (
            t_enter, f0, t_enter, f0,
            jnp.where(f0 >= 0.0, alive0, 0.0),   # found (f32 mask)
            jnp.where(f0 < 0.0, alive0, 0.0),    # alive (f32 mask)
            jnp.int32(0), car,
        )

        def cond(s):
            return (s[6] < params.max_steps) & (jnp.sum(s[5]) > 0.0)

        def body(s):
            t, f, t_prev, f_prev, found, alive, it, car = s
            if adaptive:
                # Shared piecewise bound (sphere_trace.support_radius_bound)
                # so the XLA and kernel marches take the same steps.
                d = (support_radius_bound(f + iso) - r_iso) * inv_stretch
                if deformed:
                    d = d - 2.0 * ldrift * jnp.abs(t - car[6])
                    d = jnp.maximum(shrink * d, d - slack)
                dt = jnp.maximum(base_step, 0.95 * d)
            else:
                dt = base_step
            t_new = jnp.minimum(t + dt, t_exit)
            is_alive = alive > 0.0
            # One true pull-back every k_cycle evals; the linear rest-point
            # model carries the evals in between.
            f_new, car = evaluate(t_new, car, it % k_cycle == 0, is_alive,
                                  started)
            crossed = is_alive & (f_new >= 0.0)
            done = is_alive & (t_new >= t_exit) & (f_new < 0.0)
            return (
                jnp.where(is_alive, t_new, t),
                jnp.where(is_alive, f_new, f),
                jnp.where(is_alive, t, t_prev),
                jnp.where(is_alive, f, f_prev),
                jnp.maximum(found, crossed.astype(jnp.float32)),
                alive * (1.0 - crossed.astype(jnp.float32))
                * (1.0 - done.astype(jnp.float32)),
                it + 1,
                car,
            )

        t, f, a, fa, found, _, _, car = jax.lax.while_loop(cond, body, state)
        b, fb = t, f
        hit_lanes = found > 0.0
        if deformed:
            # The bracket values may come from model evals. Re-evaluate
            # both endpoints with a true pull-back, so the bracket holds
            # true field values and the model's slope is the a -> b secant
            # of the pulled-back points: the bisection evals below ride a
            # model whose error over the bracket is O(curvature * step^2).
            fa, car = evaluate(a, car, True, hit_lanes, hit_lanes)
            fb, car = evaluate(b, car, True, hit_lanes, hit_lanes)

        def bisect(_, st):
            a, b, fa, fb, car = st
            m = 0.5 * (a + b)
            fm, car = evaluate(m, car, False, hit_lanes, hit_lanes)
            neg = fm < 0.0
            return (jnp.where(neg, m, a), jnp.where(neg, b, m),
                    jnp.where(neg, fm, fa), jnp.where(neg, fb, fm), car)

        a, b, fa, fb, _ = jax.lax.fori_loop(
            0, params.bisect_steps, bisect, (a, b, fa, fb, car)
        )
        # Closing secant on the bisected bracket (sphere_trace.trace);
        # degenerate brackets (fa == fb in f32) take the midpoint.
        denom = fb - fa
        t_sec = a - fa * (b - a) / jnp.where(
            jnp.abs(denom) < 1e-12, 1e-12, denom
        )
        t_root = jnp.where(jnp.abs(denom) < 1e-9, 0.5 * (a + b), t_sec)
        return jnp.clip(t_root, a, b), found

    def skip_tile(_):
        z = jnp.zeros_like(t_enter)
        return z, z

    # Background tiles skip the march entirely.
    return jax.lax.cond(jnp.sum(alive0) > 0.0, run_tile, skip_tile, 0)


@dataclasses.dataclass(frozen=True)
class _AdditiveCfg:
    params: TraceParams
    adaptive: bool
    block_types: tuple      # per prim block: the prim types it holds
    wendland: bool = False
    n_cb: int = 0
    sigma: float = 1.0
    fp_iters: int = 1
    k_refresh: int = K_REFRESH


def _additive_kernel(cfg: _AdditiveCfg, *refs):
    """Additive scenes: field = sum of prim fields, evaluated per
    PRIM_BLOCK with whole blocks skipped when the evaluated points' hull
    misses the block's support box (live flags precomputed in XLA from the
    tile's whole-segment hull; the per-eval hull shrinks as rays march).
    The Morton prim order makes live blocks few and dense: the analog of
    the reference's kd-tree prim culling (src/implicit/KDTree.h:95).

    With a Wendland displacement the kernel traces the deformed field:
    march points are pulled back to rest space before the prim evaluation,
    so the hull culls test rest points against rest-space boxes, exact
    under deformation."""
    (rox, roy, roz, rdx, rdy, rdz, ten, tex, alv,
     row, live, boxes, prm, *rest) = refs
    if cfg.wendland:
        clive, cboxes, cen, waff, t_out, hit_out = rest
    else:
        t_out, hit_out = rest
    iso = cfg.params.iso
    ro = (rox[...], roy[...], roz[...])
    rd = (rdx[...], rdy[...], rdz[...])
    t_enter, t_exit, alive0 = ten[...], tex[...], alv[...]
    real = [b for b, ty in enumerate(cfg.block_types) if ty]

    def field_rest(px, py, pz, mask):
        def add_block(b):
            def prim(j, acc):
                return acc + _prim_field(prm, b * PRIM_BLOCK + j, px, py, pz,
                                         cfg.block_types[b])
            return lambda acc: jax.lax.fori_loop(0, PRIM_BLOCK, prim, acc)

        f = jnp.zeros_like(px)
        if len(real) <= 4:
            # Small scene: the hull reductions and branches cost more than
            # summing every block (a block whose support misses all points
            # adds exactly 0: Wyvill compact support).
            for b in real:
                f = add_block(b)(f)
            return f - iso
        hull = _hull(mask, px, py, pz)
        for b in real:
            f = jax.lax.cond((live[b] > 0) & _box_live(hull, boxes, b),
                             add_block(b), lambda acc: acc, f)
        return f - iso

    def point(t):
        return tuple(ro[i] + t * rd[i] for i in range(3))

    if not cfg.wendland:
        def evaluate(t, carry, refresh, mask, keep):
            return field_rest(*point(t), mask), carry

        carry0 = ()
    else:
        inv_sig = 1.0 / cfg.sigma
        aff = [waff[k] for k in range(12)]

        def pull_one(xx, yy, zz, px, py, pz, mask):
            # The affine tail has global support: always on.
            u = tuple(aff[4 * i] + aff[4 * i + 1] * xx + aff[4 * i + 2] * yy
                      + aff[4 * i + 3] * zz for i in range(3))
            # Hull of the lanes whose pull-back is used: they cluster near
            # the surface, so the compact-support cull skips most center
            # blocks exactly. Lanes outside `mask` get values nobody reads.
            hull = _hull(mask, xx, yy, zz)

            def add_block(b):
                def center(j, uu):
                    k = b * CEN_BLOCK + j
                    dx = xx - cen[k, 0]
                    dy = yy - cen[k, 1]
                    dz = zz - cen[k, 2]
                    d = jnp.sqrt(dx * dx + dy * dy + dz * dz)
                    tt = jnp.minimum(d * inv_sig, 1.0)
                    omt = 1.0 - tt
                    o2 = omt * omt
                    ph = o2 * o2 * (4.0 * tt + 1.0)
                    return (uu[0] + cen[k, 3] * ph, uu[1] + cen[k, 4] * ph,
                            uu[2] + cen[k, 5] * ph)
                return lambda uu: jax.lax.fori_loop(0, CEN_BLOCK, center, uu)

            for b in range(cfg.n_cb):
                u = jax.lax.cond((clive[b] > 0) & _box_live(hull, cboxes, b),
                                 add_block(b), lambda uu: uu, u)
            return px - u[0], py - u[1], pz - u[2]

        def evaluate(t, carry, refresh, mask, keep):
            """Linear-model field eval. carry = (xr, yr, zr, vx, vy, vz,
            tr): each lane's rest point at its last refresh tr and the
            refresh-to-refresh slope v; between refreshes the rest point
            is estimated as x_est(t) = xr + (t - tr) v. A refresh pulls
            back for real (fixed-point iterations warm-started from the
            estimate, culled over the `keep` lanes, whose carry must stay
            exact: the march keeps every started lane) and refits v from
            the secant."""
            px, py, pz = point(t)
            xr, yr, zr, vx, vy, vz, tr = carry

            def do_refresh(_):
                adv = t - tr
                x2, y2, z2 = xr + adv * vx, yr + adv * vy, zr + adv * vz
                for _ in range(cfg.fp_iters):
                    x2, y2, z2 = pull_one(x2, y2, z2, px, py, pz, keep)
                # Keep the old slope when the interval is too short for a
                # stable quotient.
                big = adv > 1e-5
                inv = 1.0 / jnp.where(big, adv, 1.0)
                return (x2, y2, z2,
                        jnp.where(big, (x2 - xr) * inv, vx),
                        jnp.where(big, (y2 - yr) * inv, vy),
                        jnp.where(big, (z2 - zr) * inv, vz),
                        t)

            if refresh is True:
                car = do_refresh(0)
            elif refresh is False:
                car = carry
            else:
                car = jax.lax.cond(refresh, do_refresh, lambda _: carry, 0)
            a2 = t - car[6]
            xe = car[0] + a2 * car[3]
            ye = car[1] + a2 * car[4]
            ze = car[2] + a2 * car[5]
            return field_rest(xe, ye, ze, mask), car

        carry0 = point(t_enter) + rd + (t_enter,)

    t_root, found = _march(
        evaluate, cfg.params, cfg.adaptive, row, t_enter, t_exit, alive0,
        carry0, cfg.wendland, cfg.k_refresh if cfg.wendland else 1,
    )
    t_out[...] = jnp.where(found > 0.0, t_root, t_exit)
    hit_out[...] = found


def fold_prim_fields(scene: Scene, pf, op_param):
    """Fold per-prim fields along the scene's static operator schedule.
    pf[i] is prim i's field (any shape); op_param(k, i) is op k's i-th
    parameter. Same operator semantics as ops.field._op_apply/_op_range."""
    if not scene.root_is_op:
        return reduce(jnp.add, pf[: scene.n_prims])
    vals: dict[int, jax.Array] = {}
    for k in scene.schedule:
        w = scene.wiring[k]
        ot = w.otype
        if w.is_range:
            rows = pf[w.left : w.right + 1]
            if ot == int(OpType.UNION):
                val = reduce(jnp.maximum, rows)
            elif ot == int(OpType.INTERSECT):
                val = reduce(jnp.minimum, rows)
            elif ot == int(OpType.RICCI_BLEND):
                p0 = op_param(k, 0)
                val = jnp.power(
                    reduce(jnp.add, [jnp.power(r, p0) for r in rows]),
                    op_param(k, 1),
                )
            else:
                val = reduce(jnp.add, rows)
        else:
            lf = vals[w.left] if w.left_is_op else pf[w.left]
            if w.is_unary:
                rf = jnp.zeros_like(lf)
            else:
                rf = vals[w.right] if w.right_is_op else pf[w.right]
            if ot == int(OpType.UNION):
                val = jnp.maximum(lf, rf)
            elif ot == int(OpType.INTERSECT):
                val = jnp.minimum(lf, rf)
            elif ot == int(OpType.RICCI_BLEND):
                p0 = op_param(k, 0)
                val = jnp.power(jnp.power(lf, p0) + jnp.power(rf, p0),
                                op_param(k, 1))
            elif ot == int(OpType.DIF):
                val = jnp.minimum(lf, 1.0 - rf)
            elif ot == int(OpType.SMOOTH_DIF):
                val = lf * (1.0 - rf)
            elif ot in (int(OpType.BLEND), int(OpType.GRADIENT_BLEND),
                        int(OpType.FAST_QUADRIC_POINT_SET)):
                val = lf + rf
            else:  # warps and CACHE pass through
                val = lf
        vals[k] = val
    return vals[scene.root_idx]


def _generic_kernel(scene: Scene, params: TraceParams, *refs):
    """Any scene the fold unrolls for (differences, intersections, warp
    chains): every prim's field at every eval, folded along the scene's
    static schedule. Warp groups see their chain-warped points."""
    (rox, roy, roz, rdx, rdy, rdz, ten, tex, alv,
     row, prm, ops, t_out, hit_out) = refs
    ro = (rox[...], roy[...], roz[...])
    rd = (rdx[...], rdy[...], rdz[...])
    t_enter, t_exit, alive0 = ten[...], tex[...], alv[...]
    present = scene.prim_types_present

    def evaluate(t, carry, refresh, mask, keep):
        x, y, z = (ro[i] + t * rd[i] for i in range(3))
        pf = [None] * scene.n_prims
        for chain, prim_idx in scene.warp_groups:
            wx, wy, wz = x, y, z
            for wire in chain:
                p = tuple(ops[wire.op_idx, i] for i in range(4))
                wx, wy, wz = warp_components(
                    wire.wtype, p, wire.axis_a, wire.axis_b, wx, wy, wz
                )
            idx = prim_idx if len(scene.warp_groups) > 1 else range(
                scene.n_prims)
            for i in idx:
                if i < scene.n_prims:
                    pf[i] = _prim_field(prm, i, wx, wy, wz, present)
        f = fold_prim_fields(scene, pf, lambda k, i: ops[k, i])
        return f - params.iso, carry

    t_root, found = _march(
        evaluate, params, scene.monotone_field, row, t_enter, t_exit,
        alive0, (), False, 1,
    )
    t_out[...] = jnp.where(found > 0.0, t_root, t_exit)
    hit_out[...] = found


# --------------------------------------------------------------------------
# Wrappers (XLA side: layouts, brackets, per-tile bounds)
# --------------------------------------------------------------------------

def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _prim_table(scene: Scene) -> jax.Array:
    """[P, _PRIM_COLS] prim rows: inverse transform (12), pos, dir, res,
    type. Prim-major, so one prim's parameters share a cache line."""
    P = scene.capacity_prims
    cols = [
        scene.prim_mtx.reshape(P, 12),
        scene.prim_pos, scene.prim_dir, scene.prim_res,
        scene.prim_type.reshape(P, 1).astype(jnp.float32),
    ]
    tab = jnp.concatenate([c.astype(jnp.float32) for c in cols], -1)
    return jnp.pad(tab, ((0, 0), (0, _PRIM_COLS - tab.shape[1])))


def _box_table(lo, hi) -> jax.Array:
    """[NB, 8] box rows (lo xyz, hi xyz, 2 pad)."""
    return jnp.pad(jnp.concatenate([lo, hi], -1), ((0, 0), (0, 2)))


def _live_table(live) -> jax.Array:
    """[tiles, NB] flags padded to a power-of-two row, int32."""
    nb = live.shape[1]
    return jnp.pad(live.astype(jnp.int32), ((0, 0), (0, _pow2(nb) - nb)))


def _block_boxes(scene: Scene):
    """Per-PRIM_BLOCK support boxes and world->local stretch bounds of a
    pack-normalized additive scene (prims already Morton-ordered)."""
    P = scene.capacity_prims
    nb = P // PRIM_BLOCK
    blk_lo = scene.prim_bb_lo.reshape(nb, PRIM_BLOCK, 3).min(1)
    blk_hi = scene.prim_bb_hi.reshape(nb, PRIM_BLOCK, 3).max(1)
    # Per-prim stretch bound: min(Frobenius norm of the linear part, the
    # global spectral max); both bound the spectral norm. Padding rows
    # get 0 so they never dominate a block's max.
    frob = jnp.sqrt(jnp.sum(scene.prim_mtx[:, :, :3] ** 2, (1, 2)))
    per_prim = jnp.minimum(
        frob, jnp.float32(max(scene.max_world_to_local_scale, 1e-6))
    )
    per_prim = jnp.where(jnp.arange(P) < scene.n_prims, per_prim, 0.0)
    return blk_lo, blk_hi, per_prim.reshape(nb, PRIM_BLOCK).max(1)


def _tile_hulls(ro, rd, t_enter, t_exit, alive, tiles):
    """[tiles, 3] x2 segment hulls: every marched/refined t lies in
    [t_enter, t_exit], so points stay inside the endpoint hull."""
    a = ro + t_enter[:, None] * rd
    b = ro + t_exit[:, None] * rd
    lo_pts = jnp.where(alive[:, None], jnp.minimum(a, b), jnp.inf)
    hi_pts = jnp.where(alive[:, None], jnp.maximum(a, b), -jnp.inf)
    return (lo_pts.reshape(tiles, -1, 3).min(1),
            hi_pts.reshape(tiles, -1, 3).max(1))


def _hull_box_live(hull_lo, hull_hi, blk_lo, blk_hi):
    """[tiles, NB] bool hull/box overlap flags."""
    return jnp.all(
        (hull_lo[:, None] <= blk_hi[None] + 1e-4)
        & (hull_hi[:, None] >= blk_lo[None] - 1e-4),
        -1,
    )


def _wendland_tile_bounds(disp: WendlandDisp, hull_lo, hull_hi, alive0,
                          tiles):
    """Per-tile deformed march bounds from the compact support.

    Only center blocks whose sigma-support box touches the tile's
    (max_disp-inflated) segment hull can contribute anywhere this tile's
    pull-backs evaluate. Within that live set, L and max|u| come from the
    center-sampled per-block maxima (extended between samples by the
    render.deformed.disp_bounds_sampled safety factors); outside every
    support box u is exactly the affine tail, bounded by interval
    arithmetic over the hull box. Returns (center table, center box
    table, live flags, shrink, slack, drift L) with per-tile [tiles]
    bounds."""
    max_disp = disp.max_disp
    n_cb = disp.centers.shape[0] // CEN_BLOCK
    cblk = disp.centers.reshape(n_cb, CEN_BLOCK, 3)
    cb_lo = cblk.min(1) - disp.sigma
    cb_hi = cblk.max(1) + disp.sigma
    clive = _hull_box_live(hull_lo, hull_hi, cb_lo - max_disp,
                           cb_hi + max_disp)            # [tiles, n_cb]
    any_alive = alive0.reshape(tiles, -1).any(-1)
    live_g = jnp.max(jnp.where(clive, disp.bg[None, :], 0.0), -1)
    live_u = jnp.max(jnp.where(clive, disp.bu[None, :], 0.0), -1)
    h_c = 0.5 * (hull_lo + hull_hi)
    h_r = jnp.linalg.norm(0.5 * (hull_hi - hull_lo), axis=-1) + max_disp
    aff_c = disp.waff[:, 0][None] + jnp.einsum(
        "tk,ik->ti", h_c, disp.waff[:, 1:4],
        precision=jax.lax.Precision.HIGHEST,
    )
    aff_u = jnp.linalg.norm(aff_c, axis=-1) + disp.bfr * h_r
    l_tile = jnp.maximum(1.25 * live_g, disp.bfr)
    u_max = jnp.maximum(1.15 * live_u, aff_u)
    shrink = jnp.where(any_alive, jnp.clip(1.0 - l_tile, 0.0, 1.0), 1.0)
    slack = jnp.where(any_alive, 2.0 * u_max, 0.0)
    ldrift = jnp.where(any_alive, l_tile, 0.0)
    cen_tab = jnp.pad(
        jnp.concatenate([disp.centers, disp.w], -1).astype(jnp.float32),
        ((0, 0), (0, _CEN_COLS - 6)),
    )
    return (cen_tab, _box_table(cb_lo, cb_hi), _live_table(clive),
            shrink, slack, ldrift)


def _pad_rays(ro, rd, multiple):
    """Pad rays to a multiple; padded rays start far away pointing +x and
    miss everything."""
    n = ro.shape[0]
    pad = -n % multiple
    if pad:
        ro = jnp.concatenate([ro, jnp.full((pad, 3), 1e7, ro.dtype)], 0)
        rd = jnp.concatenate(
            [rd, jnp.tile(jnp.asarray([[1.0, 0, 0]], rd.dtype), (pad, 1))], 0
        )
    return ro, rd


def trace_pallas(scene: Scene, ro: jax.Array, rd: jax.Array,
                 params: TraceParams = TraceParams(),
                 interpret: bool = False, tile: int = TILE,
                 disp: WendlandDisp | None = None):
    """Forward sphere trace through the kernel: raw (t, hit) per ray.

    disp: optional Wendland displacement spec (render.deformed.
    wendland_pallas_spec) for the deformed-field trace; it needs an
    additive scene. The kernel traces no other interpolant: biharmonic
    deformed traces run on render.deformed.trace_deformed_rbf."""
    if disp is not None and not isinstance(disp, WendlandDisp):
        raise TypeError(
            "the trace kernel takes only a WendlandDisp; biharmonic "
            "deformed traces run on render.deformed.trace_deformed_rbf"
        )
    if tile & (tile - 1):
        raise ValueError(f"tile must be a power of two, got {tile}")
    if not kernel_supports(scene, disp is not None):
        raise ValueError("scene outside the trace kernel (see "
                         "select_trace_path)")
    n = ro.shape[0]
    ro, rd = _pad_rays(ro, rd, tile)
    tiles = ro.shape[0] // tile
    max_disp = 0.0 if disp is None else disp.max_disp
    margin = 0.05 + max_disp

    # March brackets in fused XLA (one pass over all rays), shared with
    # the XLA tracer; the kernel just marches. Warp scenes can't use the
    # per-prim support boxes (unwarped boxes don't bound the warped
    # field): slab bracket like sphere_trace.trace.
    if scene.can_cull:
        t_enter, t_exit, alive0 = prim_interval(scene, ro, rd, margin=margin)
    else:
        t_enter, t_exit = _ray_box(
            ro, rd, scene.bbox_lo[None] - margin, scene.bbox_hi[None] + margin
        )
        alive0 = t_exit > t_enter
        t_enter = jnp.where(alive0, t_enter, 0.0)
        t_exit = jnp.where(alive0, t_exit, 0.0)
    # Fixed base step from the margin-inflated bbox diagonal (matches the
    # XLA tracers and the external implicit-diff clamp).
    span = scene.bbox_hi - scene.bbox_lo + 2.0 * margin
    base_step = jnp.sqrt(jnp.sum(span * span)) * params.step_frac

    ray_args = [ro[:, 0], ro[:, 1], ro[:, 2], rd[:, 0], rd[:, 1], rd[:, 2],
                t_enter, t_exit, alive0.astype(jnp.float32)]
    ray_spec = pl.BlockSpec((tile,), lambda i: (i,))

    def whole(a):
        return pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)

    def per_tile(a):
        return pl.BlockSpec((None, a.shape[1]), lambda i: (i, 0))

    def tile_row(inv_stretch, shrink=1.0, slack=0.0, ldrift=0.0):
        cols = [inv_stretch, shrink, slack, ldrift, base_step]
        rows = jnp.stack(
            [jnp.broadcast_to(jnp.asarray(c, jnp.float32), (tiles,))
             for c in cols], -1)
        return jnp.pad(rows, ((0, 0), (0, _ROW - len(cols))))

    if scene.is_additive and scene.capacity_prims % PRIM_BLOCK == 0:
        blk_lo, blk_hi, blk_stretch = _block_boxes(scene)
        # The static live test sees the deformed-space segment hull, so the
        # rest-space block boxes get the max-displacement inflation; the
        # in-kernel cull tests pulled-back points against the exact boxes.
        hull_lo, hull_hi = _tile_hulls(ro, rd, t_enter, t_exit, alive0,
                                       tiles)
        live = _hull_box_live(hull_lo, hull_hi, blk_lo - max_disp,
                              blk_hi + max_disp)
        # Per-tile stretch: max world->local scale over the prims this
        # tile's rays can reach. Sound for the step bound (prims outside
        # the segment hull are never crossed here) and tighter than the
        # global max on mixed-scale scenes.
        tile_stretch = jnp.max(jnp.where(live, blk_stretch[None], 0.0), -1)
        inv_stretch = 1.0 / jnp.maximum(tile_stretch, 1e-6)
        block_types = scene.additive_block_types or (
            (scene.prim_types_present,) * blk_lo.shape[0]
        )
        cfg = _AdditiveCfg(params, scene.monotone_field, block_types)
        extra = []
        if disp is None:
            row = tile_row(inv_stretch)
        else:
            cen_tab, cbox, clive, shrink, slack, ldrift = (
                _wendland_tile_bounds(disp, hull_lo, hull_hi, alive0, tiles)
            )
            row = tile_row(inv_stretch, shrink, slack, ldrift)
            waff = jnp.pad(disp.waff.reshape(12).astype(jnp.float32), (0, 4))
            extra = [clive, cbox, cen_tab, waff]
            cfg = dataclasses.replace(
                cfg, wendland=True, n_cb=cbox.shape[0],
                sigma=float(disp.sigma), fp_iters=int(disp.fp_iters),
                k_refresh=int(disp.k_refresh) or K_REFRESH,
            )
        tables = [row, _live_table(live), _box_table(blk_lo, blk_hi),
                  _prim_table(scene)] + extra
        specs = [per_tile(row), per_tile(tables[1])] + [
            whole(a) for a in tables[2:]
        ]
        if disp is not None:
            specs[4] = per_tile(extra[0])
        kernel = partial(_additive_kernel, cfg)
        name = "sphere_trace_deformed" if disp is not None else "sphere_trace"
    else:
        row = tile_row(1.0 / max(scene.max_world_to_local_scale, 1e-6))
        ops = jnp.pad(scene.op_params.astype(jnp.float32),
                      ((0, 0), (0, 4 - scene.op_params.shape[1])))
        tables = [row, _prim_table(scene), ops]
        specs = [per_tile(row), whole(tables[1]), whole(ops)]
        kernel = partial(_generic_kernel, scene, params)
        name = "sphere_trace_generic"

    out_shape = [jax.ShapeDtypeStruct((tiles * tile,), jnp.float32)] * 2
    t, hit = pl.pallas_call(
        kernel,
        grid=(tiles,),
        in_specs=[ray_spec] * 9 + specs,
        out_specs=[ray_spec, ray_spec],
        out_shape=out_shape,
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        name=name,
    )(*ray_args, *tables)
    return t[:n], hit[:n] > 0.5


def block_permutation(height: int, width: int, bh: int, bw: int):
    """Row-major -> block-major pixel permutation as an index array (the
    order _block_layout produces by pad + transpose). Returns [Hpad*Wpad]
    indices into the row-major ray array, -1 for padding."""
    import numpy as np

    hb, wb = -(-height // bh), -(-width // bw)
    yy, xx = np.meshgrid(
        np.arange(hb * bh), np.arange(wb * bw), indexing="ij"
    )
    flat = np.where((yy < height) & (xx < width), yy * width + xx, -1)
    return (
        flat.reshape(hb, bh, wb, bw).transpose(0, 2, 1, 3).reshape(-1)
    )


def block_shape(tile: int) -> tuple[int, int]:
    """Near-square bh x bw pixel block of one tile (bh * bw == tile)."""
    bh = 1 << (int(math.log2(tile)) // 2)
    return bh, tile // bh


def _block_layout(height: int, width: int, tile: int):
    """Row-major <-> block-major converters for the coherent-tile image
    path: (to_blocks, from_blocks, (pad_h, pad_w), n_block_rays). Row-major
    ray order makes a tile span part of an image row, mixing background
    and surface rays, so the tile's early exit waits on its slowest ray;
    bh x bw pixel blocks make tiles spatially coherent. Pad + reshape +
    transpose: a copy, no gather. Same order as block_permutation."""
    bh, bw = block_shape(tile)
    hb, wb = -(-height // bh), -(-width // bw)
    ph, pw = hb * bh - height, wb * bw - width

    def to_blocks(a, fill):
        img = a.reshape(height, width, 3)
        img = jnp.pad(img, ((0, ph), (0, pw), (0, 0)),
                      constant_values=fill)
        img = img.reshape(hb, bh, wb, bw, 3).transpose(0, 2, 1, 3, 4)
        return img.reshape(-1, 3)

    def from_blocks(a):
        img = a.reshape(hb, wb, bh, bw).transpose(0, 2, 1, 3)
        img = img.reshape(hb * bh, wb * bw)[:height, :width]
        return img.reshape(-1)

    return to_blocks, from_blocks, (ph, pw), hb * wb * bh * bw


def _image_rays_to_blocks(ro, rd, height, width, tile):
    """Permute row-major image rays into coherent pixel blocks; padded
    rays start far away pointing +x and miss everything (same convention
    as _pad_rays)."""
    to_blocks, from_blocks, (ph, pw), _ = _block_layout(height, width, tile)
    ro_b = to_blocks(ro, 1e7)
    rd_b = to_blocks(rd, 0.0)
    if pw or ph:
        mask = to_blocks(jnp.ones_like(ro), 0.0)[:, :1] > 0.5
        rd_b = jnp.where(mask, rd_b, jnp.asarray([1.0, 0.0, 0.0]))
    return ro_b, rd_b, from_blocks


def trace_pallas_image(scene: Scene, ro: jax.Array, rd: jax.Array,
                       height: int, width: int,
                       params: TraceParams = TraceParams(),
                       interpret: bool = False, tile: int = TILE,
                       disp: WendlandDisp | None = None):
    """trace_pallas over a row-major H x W ray grid with block-coherent
    tiles (one bh x bw pixel block per program, see _block_layout);
    results come back in row-major order."""
    ro_b, rd_b, from_blocks = _image_rays_to_blocks(
        ro, rd, height, width, tile
    )
    t_b, hit_b = trace_pallas(scene, ro_b, rd_b, params, interpret=interpret,
                              tile=tile, disp=disp)
    return from_blocks(t_b), from_blocks(hit_b)


def trace_pallas_sharded(scene: Scene, ro: jax.Array, rd: jax.Array,
                         device_mesh, axis=None,
                         params: TraceParams = TraceParams(),
                         interpret: bool = False, tile: int = TILE,
                         disp: WendlandDisp | None = None):
    """trace_pallas with the rays sharded over a device mesh.

    Tiles are independent (SURVEY §2.6 P7: rays are the data-parallel
    axis), so the SPMD form is exact: rays split evenly across `axis`
    (default: all mesh axes combined), the scene and the displacement spec
    are replicated (a few KB; never shard the scene), and each device runs
    the single-device kernel on its local tiles. The forward trace needs
    no collective. Returns row-sharded (t, hit) of the input length."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    if axis is None:
        axis = device_mesh.axis_names
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    nd = math.prod(device_mesh.shape[a] for a in names)

    n = ro.shape[0]
    ro, rd = _pad_rays(ro, rd, nd * tile)
    disp_arrs = () if disp is None else (disp,)

    @partial(
        shard_map,
        mesh=device_mesh,
        in_specs=(P(), P(axis), P(axis)) + (P(),) * len(disp_arrs),
        out_specs=(P(axis), P(axis)),
        # pallas_call's out_shape carries no varying-mesh-axes metadata;
        # the kernel is per-shard pure so the static check is moot.
        check_vma=False,
    )
    def shard_trace(scene_, ro_, rd_, *disp_):
        t, hit = trace_pallas(
            scene_, ro_, rd_, params, interpret=interpret, tile=tile,
            disp=disp_[0] if disp_ else None,
        )
        return t, hit.astype(jnp.int32)

    t, hit = shard_trace(scene, ro, rd, *disp_arrs)
    return t[:n], hit[:n] > 0


def trace_pallas_image_sharded(scene: Scene, ro: jax.Array, rd: jax.Array,
                               height: int, width: int, device_mesh,
                               axis=None,
                               params: TraceParams = TraceParams(),
                               interpret: bool = False,
                               tile: int = TILE,
                               disp: WendlandDisp | None = None):
    """Sharded block-coherent image trace: the row-major -> pixel-block
    permutation runs once globally (pad + transpose), then the coherent
    tile stream shards over the mesh via trace_pallas_sharded."""
    ro_b, rd_b, from_blocks = _image_rays_to_blocks(
        ro, rd, height, width, tile
    )
    t_b, hit_b = trace_pallas_sharded(
        scene, ro_b, rd_b, device_mesh, axis=axis, params=params,
        interpret=interpret, tile=tile, disp=disp,
    )
    return from_blocks(t_b), from_blocks(hit_b)


def zero_cotangent(raw):
    """Wrap a forward-only trace raw(scene, *arrays) -> (t, hit) in a
    custom VJP whose cotangent is zero for every input: the callers use
    its output only under stop_gradient and carry the true derivative in
    the implicit-differentiation correction."""
    fn = jax.custom_vjp(raw)

    def fwd(*args):
        return fn(*args), args

    def bwd(args, _):
        def zero(x):
            x = jnp.asarray(x)
            if jnp.issubdtype(x.dtype, jnp.floating):
                return jnp.zeros_like(x)
            return jnp.zeros(x.shape, jax.dtypes.float0)
        return jax.tree_util.tree_map(zero, args)

    fn.defvjp(fwd, bwd)
    return fn


def trace_fast(scene: Scene, ro: jax.Array, rd: jax.Array,
               params: TraceParams = TraceParams(),
               interpret: bool = False):
    """Rest trace on the selected path with the XLA tracer's gradients:
    the kernel's forward march plus the implicit-differentiation
    correction. Off the kernel (select_trace_path) it is the XLA tracer."""
    if not select_trace_path(scene, interpret=interpret).kernel:
        return trace_xla(scene, ro, rd, params)

    raw = zero_cotangent(
        lambda s, o, d: trace_pallas(s, o, d, params, interpret=interpret)
    )
    t_root, found = raw(scene, ro, rd)
    t0 = jax.lax.stop_gradient(t_root)
    x0 = ro + t0[:, None] * rd
    g = gradient(scene, x0)
    dfdt = jnp.sum(g * rd, -1)
    dfdt = jax.lax.stop_gradient(
        jnp.where(jnp.abs(dfdt) < 1e-6, jnp.where(dfdt < 0, -1e-6, 1e-6), dfdt)
    )
    f_at = field(scene, x0) - params.iso
    # Clamp the first-order nudge to step scale (see sphere_trace.trace):
    # tangent rays would otherwise catapult t through the 1e-6 dfdt floor.
    diag = jnp.sqrt(jnp.sum((scene.bbox_hi - scene.bbox_lo + 0.1) ** 2))
    cap = 0.5 * diag * params.step_frac
    t_hit = jnp.where(found, t0 - jnp.clip(f_at / dfdt, -cap, cap), t0)
    return t_hit, found
