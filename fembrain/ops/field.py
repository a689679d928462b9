"""Vectorized BlobTree field evaluation — the core compute primitive.

A data-parallel re-design of the reference's field evaluator
(data/opencl/Polygonizer.cl:483-886 `ComputePrimitiveField` /
`ComputeOpField` / `ComputeField`): instead of per-point tree traversal we
evaluate *all primitive fields for all points* as one batched computation
(the 3x4 inverse-transform batch is one matmul), then fold operators in
topological order. The operator fold unrolls at trace
time over the scene's static wiring, producing a pure dataflow graph that
XLA fuses — and that is differentiable end-to-end (normals via `jax.grad`
replace the reference's forward differences, Polygonizer.cl:1134-1173).

Everything here is shape-polymorphic over a flat point batch [N, 3] and is
the single source of field semantics shared by the sphere tracer, the
polygonizer, FEM coupling, and the tests.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..blob.scene import Scene
from ..blob.types import OpType, PrimType
from .warp import warp_components, warp_point

_BIG = 10.0  # reference's "far" squared distance for NULL prims


def wyvill(dd: jax.Array) -> jax.Array:
    """Wyvill kernel (1-d^2)^3 for d^2<1 else 0 (Polygonizer.cl:278-284)."""
    t = jnp.maximum(0.0, 1.0 - dd)
    return t * t * t


def _safe_div(num, den, eps=1e-12):
    return num / jnp.where(jnp.abs(den) < eps, jnp.where(den < 0, -eps, eps), den)


# All distance functions work on COMPONENT (SoA) arrays: vt is a 3-tuple
# of coordinate arrays ([N, G] planes here, [T] ray vectors in the trace
# kernel) and prim params are broadcastable tuples (rows or scalars). No
# size-3 trailing axis, so the same code lowers inside Pallas kernels.


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _dist2_point(vt, pos, dirv, res):
    d = _sub3(pos, vt)
    return _dot3(d, d)


def _dist2_line(vt, pos, dirv, res):
    # pos = segment start, dirv = segment end (Polygonizer.cl:549-557).
    delta = _sub3(dirv, pos)
    dd = _dot3(delta, delta)
    t = _safe_div(_dot3(_sub3(vt, pos), delta), dd)
    proj = tuple(pos[i] + t * delta[i] for i in range(3))
    d = _sub3(vt, proj)
    return _dot3(d, d)


def _dist2_cylinder(vt, pos, dirv, res):
    # res = (radius, height, ...) (Polygonizer.cl:559-571).
    # The 1e-20 floor keeps the sqrt gradient finite for on-axis queries
    # (max saturates -> zero partial instead of inf * 0 = NaN), and makes
    # the formula safe as the degenerate-POINT branch (dirv = 0, r = h =
    # 0 gives d^2 = |p|^2 to 1 ulp).
    p = _sub3(vt, pos)
    y = _dot3(p, dirv)
    pp = _dot3(p, p)
    x = jnp.maximum(0.0, jnp.sqrt(jnp.maximum(pp - y * y, 1e-20)) - res[0])
    y = jnp.where(y > 0.0, jnp.maximum(0.0, y - res[1]), y)
    return x * x + y * y


def _dist2_cube(vt, pos, dirv, res):
    # res = (side, ...) — axis-aligned in local space (Polygonizer.cl:587-637).
    side = res[0]
    out = 0.0
    for i in range(3):
        d = jnp.maximum(jnp.abs(vt[i] - pos[i]) - side, 0.0)
        out = out + d * d
    return out


def _disc_ring_common(vt, pos, dirv, r):
    delta = _sub3(vt, pos)
    dn = _dot3(delta, dirv)
    in_plane = tuple(delta[i] - dn * dirv[i] for i in range(3))
    len2 = _dot3(in_plane, in_plane)
    dd = _dot3(delta, delta)
    inv_len = jax.lax.rsqrt(jnp.where(len2 < 1e-24, 1.0, len2))
    edge = tuple(r * in_plane[i] * inv_len - delta[i] for i in range(3))
    edge2 = _dot3(edge, edge)
    return len2, dd, edge2


def _dist2_disc(vt, pos, dirv, res):
    # dirv = unit normal, res = (radius, ...) (Polygonizer.cl:639-654).
    r = res[0]
    len2, dd, edge2 = _disc_ring_common(vt, pos, dirv, r)
    return jnp.where(len2 <= r * r, jnp.abs(dd - len2), edge2)


def _dist2_ring(vt, pos, dirv, res):
    # dirv = unit normal, res = (radius, ...) (Polygonizer.cl:656-671).
    r = res[0]
    len2, dd, edge2 = _disc_ring_common(vt, pos, dirv, r)
    return jnp.where(len2 < 1e-24, r * r + dd, edge2)


def _dist2_triangle(vt, pos, dirv, res):
    """Exact point-triangle squared distance (corners pos, dirv, res[:3]).

    The reference's triangle branch is disabled and returns far-field
    (Polygonizer.cl:573-585); we implement the real distance via the
    region-free clamped-projection formulation (Ericson RTCD 5.1.5).
    """
    a, b, c = pos, dirv, (res[0], res[1], res[2])
    ab = _sub3(b, a)
    ac = _sub3(c, a)
    d1 = _dot3(ab, _sub3(vt, a))
    d2 = _dot3(ac, _sub3(vt, a))
    d3 = _dot3(ab, _sub3(vt, b))
    d4 = _dot3(ac, _sub3(vt, b))
    d5 = _dot3(ab, _sub3(vt, c))
    d6 = _dot3(ac, _sub3(vt, c))

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    v = _safe_div(vb, denom)
    w = _safe_div(vc, denom)
    p_face = tuple(a[i] + v * ab[i] + w * ac[i] for i in range(3))

    def seg_closest(p0, e, num, den):
        t = jnp.clip(_safe_div(num, den), 0.0, 1.0)
        return tuple(p0[i] + t * e[i] for i in range(3))

    p_ab = seg_closest(a, ab, d1, d1 - d3)
    p_ac = seg_closest(a, ac, d2, d2 - d6)
    bc = _sub3(c, b)
    p_bc = seg_closest(b, bc, d4 - d3, (d4 - d3) + (d5 - d6))

    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    at_a = (d1 <= 0) & (d2 <= 0)
    at_b = (d3 >= 0) & (d4 <= d3)
    at_c = (d6 >= 0) & (d5 <= d6)

    closest = []
    for i in range(3):
        ci = p_face[i]
        ci = jnp.where(in_bc, p_bc[i], ci)
        ci = jnp.where(in_ac, p_ac[i], ci)
        ci = jnp.where(in_ab, p_ab[i], ci)
        ci = jnp.where(at_c, c[i], ci)
        ci = jnp.where(at_b, b[i], ci)
        ci = jnp.where(at_a, a[i], ci)
        closest.append(ci)
    d = _sub3(vt, tuple(closest))
    return _dot3(d, d)


_DIST2_FNS = {
    int(PrimType.POINT): _dist2_point,
    int(PrimType.LINE): _dist2_line,
    int(PrimType.CYLINDER): _dist2_cylinder,
    int(PrimType.DISC): _dist2_disc,
    int(PrimType.RING): _dist2_ring,
    int(PrimType.CUBE): _dist2_cube,
    int(PrimType.TRIANGLE): _dist2_triangle,
}


def _typed_dist2(vt, pos_c, dir_c, res_c, type_row, present, dtype):
    """Squared skeleton distance per prim with one branch per present type.

    When a scene mixes POINT with LINE or CYLINDER prims, points are
    routed through the other branch in degenerate form — LINE with
    dir := pos (delta = 0 => t = 0 => proj = pos, bit-identical to the
    point formula) or CYLINDER with dir = 0, r = h = 0 (d^2 = |p|^2 to
    1 ulp) — saving a whole [N, G] branch pass plus its select in the
    hot field evaluation (e.g. ventricle = 15 points + 2 cylinders).
    """
    merge_into = None
    if int(PrimType.POINT) in present:
        if int(PrimType.LINE) in present:
            merge_into = int(PrimType.LINE)
        elif int(PrimType.CYLINDER) in present:
            merge_into = int(PrimType.CYLINDER)
    dist2 = jnp.full(vt[0].shape, _BIG, dtype)
    zero = jnp.zeros_like(pos_c[0])
    for t, fn in _DIST2_FNS.items():
        if t not in present:
            continue
        if merge_into is not None and t == int(PrimType.POINT):
            continue
        if merge_into is not None and t == merge_into:
            is_pt = type_row == int(PrimType.POINT)
            if t == int(PrimType.LINE):
                dir_eff = tuple(
                    jnp.where(is_pt, pos_c[i], dir_c[i]) for i in range(3)
                )
                res_eff = res_c
            else:  # CYLINDER
                dir_eff = tuple(
                    jnp.where(is_pt, zero, dir_c[i]) for i in range(3)
                )
                res_eff = (
                    jnp.where(is_pt, zero, res_c[0]),
                    jnp.where(is_pt, zero, res_c[1]),
                ) + tuple(res_c[2:])
            d2 = fn(vt, pos_c, dir_eff, res_eff)
            sel = is_pt | (type_row == t)
        else:
            d2 = fn(vt, pos_c, dir_c, res_c)
            sel = type_row == t
        dist2 = jnp.where(sel, d2, dist2)
    return dist2


def prim_fields(scene: Scene, points: jax.Array) -> jax.Array:
    """Field of every primitive at every point: [N, 3] -> [N, P].

    Pipeline per primitive: world point -> warp chain (root-first) ->
    inverse node transform (3x4 matrix, batched as a matmul) -> squared
    distance by skeleton type -> Wyvill kernel.
    """
    N = points.shape[0]
    P = scene.capacity_prims
    out = jnp.zeros((N, P), points.dtype)

    for chain, prim_idx in scene.warp_groups:
        if not prim_idx and len(scene.warp_groups) > 1:
            continue
        # Points seen by this group after unwarping (shared by its prims).
        pts = points
        for wire in chain:
            pts = warp_point(
                wire.wtype,
                scene.op_params[wire.op_idx],
                wire.axis_a,
                wire.axis_b,
                pts,
            )
        idx = jnp.asarray(prim_idx, jnp.int32) if prim_idx else None
        if len(scene.warp_groups) == 1:
            # Fast path: no gather, evaluate all (incl. padding) prims.
            mtx = scene.prim_mtx
            ptype = scene.prim_type
            pos, dirv, res = scene.prim_pos, scene.prim_dir, scene.prim_res
            cols = None
        else:
            mtx = scene.prim_mtx[idx]
            ptype = scene.prim_type[idx]
            pos, dirv, res = (
                scene.prim_pos[idx],
                scene.prim_dir[idx],
                scene.prim_res[idx],
            )
            cols = idx

        f = _group_fields(pts, mtx, ptype, pos, dirv, res, scene.prim_types_present)
        if cols is None:
            out = f
        else:
            out = out.at[:, cols].set(f)
    return out


def _group_fields(pts, mtx, ptype, pos, dirv, res, present):
    """[N,3] points x [G] prims -> [N,G] fields; `present` is the static
    set of primitive types in the scene (only those branches are emitted).

    Component (SoA) formulation: the local transform is three [N,4]x[4,G]
    matmuls, and all skeleton distances operate on [N,G] coordinate
    planes.
    """
    ph = jnp.concatenate([pts, jnp.ones_like(pts[:, :1])], -1)  # [N,4]
    # HIGHEST precision: a default-precision f32 matmul may run in TF32
    # (about three decimal digits), a field error far above the march
    # tolerance; the transform is a tiny fraction of the FLOPs.
    vt = tuple(
        jnp.dot(
            ph,
            mtx[:, i, :].T,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        for i in range(3)
    )  # 3 x [N, G]

    pos_c = tuple(pos[:, i][None, :] for i in range(3))
    dir_c = tuple(dirv[:, i][None, :] for i in range(3))
    res_c = tuple(res[:, i][None, :] for i in range(4))
    type_row = ptype[None, :]

    present = set(int(t) for t in present)
    dist2 = _typed_dist2(vt, pos_c, dir_c, res_c, type_row, present, pts.dtype)
    f = wyvill(dist2)

    if int(PrimType.QUADRIC_POINT) in present:
        # Quadric point: polynomial inside support radius, else Wyvill of
        # dist^2 (Polygonizer.cl:673-686).
        d = _sub3(vt, pos_c)
        dd = _dot3(d, d)
        rs = dir_c[2]
        quad = dd * dd * res_c[0] + dd * res_c[1] + res_c[2]
        fq = jnp.where(rs > dd, quad, wyvill(dd))
        f = jnp.where(type_row == int(PrimType.QUADRIC_POINT), fq, f)
    return f


def _op_apply(otype: int, lf, rf, params):
    """Binary operator semantics (Polygonizer.cl:697-729 `ComputeOpField`,
    cross-checked vs the CPU path src/implicit/Polygonizer.cpp:2018-2065)."""
    if otype == int(OpType.UNION):
        return jnp.maximum(lf, rf)
    if otype == int(OpType.INTERSECT):
        return jnp.minimum(lf, rf)
    if otype in (int(OpType.BLEND), int(OpType.GRADIENT_BLEND),
                 int(OpType.FAST_QUADRIC_POINT_SET)):
        return lf + rf
    if otype == int(OpType.RICCI_BLEND):
        p, inv_p = params[0], params[1]
        return jnp.power(jnp.power(lf, p) + jnp.power(rf, p), inv_p)
    if otype == int(OpType.DIF):
        return jnp.minimum(lf, 1.0 - rf)
    if otype == int(OpType.SMOOTH_DIF):
        return lf * (1.0 - rf)
    # Warps and CACHE are pass-through in the fold (warp geometry is applied
    # via per-prim chains; reference CPU semantics Polygonizer.cpp:2048-2063).
    return lf


def _op_range(otype: int, fields, params):
    """Range-op fold over a contiguous primitive span [N, R] -> [N]
    (Polygonizer.cl:731-770 `ComputeRangeField`).

    Note: the reference folds INTERSECT from 0.0 which always yields 0 for
    non-negative fields; we use the mathematically-intended masked min.
    """
    if otype == int(OpType.UNION):
        return jnp.max(fields, -1)
    if otype == int(OpType.INTERSECT):
        return jnp.min(fields, -1)
    if otype == int(OpType.RICCI_BLEND):
        p, inv_p = params[0], params[1]
        return jnp.power(jnp.sum(jnp.power(fields, p), -1), inv_p)
    # BLEND and everything else: sum.
    return jnp.sum(fields, -1)


# Above this op count the fold switches from trace-time unrolling to a
# register-allocated lax.scan (bounded compile time for instancing-heavy
# scenes like the piza stress models).
UNROLL_LIMIT = 96


def supports_rows_fast_path(scene: Scene) -> bool:
    """Whether the trace kernel's per-prim evaluator can unroll this
    scene's fold (render.pallas_trace.fold_prim_fields). Warp chains are
    handled in-kernel (component-form warp_components), so blend+warp
    scenes (BASELINE config #2) get kernel speed too."""
    return len(scene.schedule) <= UNROLL_LIMIT


def rows_prim_fields(vt, pos_c, dir_c, res_c, type_col, present):
    """Primitive fields from component coordinates: vt is a 3-tuple of
    local coordinates, prim params are tuples broadcastable against them
    (one prim's scalars in the trace kernel); returns Wyvill fields of
    vt's shape."""
    present = set(int(t) for t in present)
    dist2 = _typed_dist2(vt, pos_c, dir_c, res_c, type_col, present,
                         vt[0].dtype)
    pf = wyvill(dist2)
    if int(PrimType.QUADRIC_POINT) in present:
        d = _sub3(vt, pos_c)
        dd = _dot3(d, d)
        quad = dd * dd * res_c[0] + dd * res_c[1] + res_c[2]
        fq = jnp.where(dir_c[2] > dd, quad, wyvill(dd))
        pf = jnp.where(type_col == int(PrimType.QUADRIC_POINT), fq, pf)
    return pf


def _fold(scene: Scene, pf: jax.Array) -> jax.Array:
    """Operator fold over a primitive-field matrix [N, P] -> [N]."""
    if not scene.root_is_op:
        # No operators: blend (sum) all primitives — CPU reference semantics
        # (Polygonizer.cpp:2088-2097); exact for the 1-prim case.
        return jnp.sum(pf[:, : scene.n_prims], -1)
    if len(scene.schedule) <= UNROLL_LIMIT:
        return _fold_unrolled(scene, pf)
    return _fold_scan(scene, pf)


def field(scene: Scene, points: jax.Array) -> jax.Array:
    """BlobTree field at points [..., 3] -> [...]."""
    shape = points.shape[:-1]
    pts = points.reshape(-1, 3)
    return _fold(scene, prim_fields(scene, pts)).reshape(shape)


def _fold_unrolled(scene: Scene, pf: jax.Array) -> jax.Array:
    op_vals: dict[int, jax.Array] = {}
    for k in scene.schedule:
        w = scene.wiring[k]
        params = scene.op_params[k]
        if w.is_range:
            val = _op_range(w.otype, pf[:, w.left : w.right + 1], params)
        else:
            lf = op_vals[w.left] if w.left_is_op else pf[:, w.left]
            if w.is_unary:
                rf = jnp.zeros_like(lf)
            else:
                rf = op_vals[w.right] if w.right_is_op else pf[:, w.right]
            val = _op_apply(w.otype, lf, rf, params)
        op_vals[k] = val
    return op_vals[scene.root_idx]


def _range_values_segmented(scene: Scene, pf: jax.Array) -> jax.Array:
    """All range-op values at once via segment reductions: [n_ranges, N].

    Range spans are disjoint (each primitive has exactly one parent), so a
    single segment-id vector over the primitive axis computes every range
    op's reduction in one pass — no per-op slicing, flat compile time.
    """
    import numpy as np

    ranges = [
        (k, scene.wiring[k]) for k in scene.schedule if scene.wiring[k].is_range
    ]
    R = len(ranges)
    N, P = pf.shape
    if R == 0:
        return jnp.zeros((1, N), pf.dtype)

    seg = np.full(P, R, np.int32)
    otypes = np.zeros(R, np.int32)
    for slot, (k, w) in enumerate(ranges):
        seg[w.left : w.right + 1] = slot
        otypes[slot] = w.otype
    seg_j = jnp.asarray(seg)
    otypes_j = jnp.asarray(otypes)[:, None]  # [R, 1]
    pfT = pf.T  # [P, N]

    present = set(int(t) for t in otypes)
    rsum = rmax = rmin = rricci = None
    if present & {int(OpType.BLEND), int(OpType.GRADIENT_BLEND),
                  int(OpType.FAST_QUADRIC_POINT_SET), int(OpType.DIF),
                  int(OpType.SMOOTH_DIF)} or True:
        rsum = jax.ops.segment_sum(pfT, seg_j, num_segments=R + 1)[:R]
    if int(OpType.UNION) in present:
        rmax = jax.ops.segment_max(pfT, seg_j, num_segments=R + 1)[:R]
    if int(OpType.INTERSECT) in present:
        rmin = jax.ops.segment_min(pfT, seg_j, num_segments=R + 1)[:R]
    if int(OpType.RICCI_BLEND) in present:
        # Per-prim power = its range op's power; padded prims get power 1.
        pw_slot = scene.op_params[jnp.asarray([k for k, _ in ranges]), 0]
        inv_slot = scene.op_params[jnp.asarray([k for k, _ in ranges]), 1]
        pw_col = jnp.concatenate([pw_slot, jnp.ones(1, pf.dtype)])[seg_j]
        spow = jax.ops.segment_sum(
            jnp.power(pfT, pw_col[:, None]), seg_j, num_segments=R + 1
        )[:R]
        rricci = jnp.power(spow, inv_slot[:, None])

    rv = rsum
    if rmax is not None:
        rv = jnp.where(otypes_j == int(OpType.UNION), rmax, rv)
    if rmin is not None:
        rv = jnp.where(otypes_j == int(OpType.INTERSECT), rmin, rv)
    if rricci is not None:
        rv = jnp.where(otypes_j == int(OpType.RICCI_BLEND), rricci, rv)
    return rv


def _fold_scan(scene: Scene, pf: jax.Array) -> jax.Array:
    """Uniform scan over the register-allocated fold plan.

    Carry is a [R, N] register file where R = max live op values (tree
    depth bound) — compile time and memory stay flat no matter how many
    operators the (instance-flattened) scene has.
    """
    from ..blob.scene import SRC_PRIM, SRC_RANGE, SRC_REG

    N = pf.shape[0]
    plan = scene.fold_plan
    rv = _range_values_segmented(scene, pf)

    steps = jnp.asarray(plan, jnp.int32)  # [S, 7]
    params_seq = scene.op_params[steps[:, 0]]  # [S, 4]

    def fetch(kind, idx, regs):
        from_reg = jax.lax.dynamic_index_in_dim(regs, idx, 0, keepdims=False)
        from_prim = jax.lax.dynamic_slice_in_dim(pf, idx, 1, 1)[:, 0]
        from_range = jax.lax.dynamic_index_in_dim(rv, idx, 0, keepdims=False)
        out = jnp.where(kind == SRC_REG, from_reg, 0.0)
        out = jnp.where(kind == SRC_PRIM, from_prim, out)
        out = jnp.where(kind == SRC_RANGE, from_range, out)
        return out

    def op_branch(otype):
        def f(lf, rf, params):
            return _op_apply(otype, lf, rf, params)
        return f

    branches = [op_branch(t) for t in range(13)]

    def body(regs, step_in):
        step, params = step_in
        _, otype, dst, lk, li, rk, ri = (step[i] for i in range(7))
        lf = fetch(lk, li, regs)
        rf = fetch(rk, ri, regs)
        val = jax.lax.switch(jnp.clip(otype, 0, 12), branches, lf, rf, params)
        regs = jax.lax.dynamic_update_index_in_dim(regs, val, dst, 0)
        return regs, None

    regs0 = jnp.zeros((scene.fold_registers, N), pf.dtype)
    regs, _ = jax.lax.scan(body, regs0, (steps, params_seq))
    return regs[scene.root_reg]


def field_via(scene: Scene, points: jax.Array, strategy: str) -> jax.Array:
    """Field evaluation with an explicit fold strategy — the analog of the
    reference's FieldComputer benchmark wrapper that exposes its stackless
    vs explicit-stack traversal kernels side by side
    (src/implicit/FieldComputer.cpp:34-56, 253-330). Strategies:

      'unrolled' — trace-time dataflow unroll (the stackless-route analog)
      'scan'     — register-file lax.scan fold (the runtime-stack analog)

    Both produce identical values; `field` picks automatically by op count.
    """
    shape = points.shape[:-1]
    pf = prim_fields(scene, points.reshape(-1, 3))
    if not scene.root_is_op:
        return jnp.sum(pf[:, : scene.n_prims], -1).reshape(shape)
    if strategy == "unrolled":
        out = _fold_unrolled(scene, pf)
    elif strategy == "scan":
        out = _fold_scan(scene, pf)
    else:
        raise ValueError(f"unknown fold strategy {strategy!r}")
    return out.reshape(shape)


def field_and_color(scene: Scene, points: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Field plus field-weighted material color [..., 3]->([...], [..., 4]).

    The reference accumulates color as a field-weighted sum of primitive
    diffuse colors normalized by total weight (Polygonizer.cl:895-1128
    `ComputeFieldAndColor`); we reproduce that weighting directly from the
    primitive field matrix.
    """
    shape = points.shape[:-1]
    pts = points.reshape(-1, 3)
    pf = prim_fields(scene, pts)        # ONE primitive pass shared by
    n = scene.n_prims                   # color weighting and the fold
    w = pf[:, :n]
    wsum = jnp.sum(w, -1, keepdims=True)
    colors = scene.prim_color[:n]
    col = (w @ colors) / jnp.maximum(wsum, 1e-8)
    f = _fold(scene, pf)
    return f.reshape(shape), col.reshape(*shape, 4)


def vertex_attributes(scene: Scene, points: jax.Array):
    """(field, gradient, color) at points [..., 3] in ONE fused primitive
    evaluation: the color is carried as the aux output of the gradient's
    forward pass, so the polygonizer's per-vertex attribute stage
    (reference ComputeVertexAttribs, Polygonizer.cl:1429-1561 — which
    pays 6 field evaluations per vertex) costs one forward + one
    backward sweep total."""
    shape = points.shape[:-1]
    pts = points.reshape(-1, 3)

    def f1(p):
        pf = prim_fields(scene, p[None])
        n = scene.n_prims
        w = pf[:, :n]
        wsum = jnp.sum(w, -1, keepdims=True)
        col = (w @ scene.prim_color[:n]) / jnp.maximum(wsum, 1e-8)
        f = _fold(scene, pf)[0]
        return f, (f, col[0])

    g, (f, col) = jax.vmap(jax.grad(f1, has_aux=True))(pts)
    return (
        f.reshape(shape),
        g.reshape(*shape, 3),
        col.reshape(*shape, 4),
    )


def gradient(scene: Scene, points: jax.Array) -> jax.Array:
    """∇field at points [..., 3] -> [..., 3] via autodiff (replaces the
    reference's forward differences, Polygonizer.cl:1134-1150)."""
    shape = points.shape[:-1]
    pts = points.reshape(-1, 3)
    g = jax.vmap(jax.grad(lambda p: field(scene, p[None])[0]))(pts)
    return g.reshape(*shape, 3)


def normal(scene: Scene, points: jax.Array) -> jax.Array:
    """Outward surface normal = -∇f / |∇f| (Polygonizer.cl:1152-1173)."""
    g = gradient(scene, points)
    n2 = jnp.sum(g * g, -1, keepdims=True)
    return -g * jax.lax.rsqrt(jnp.maximum(n2, 1e-24))


@partial(jax.jit, static_argnames=())
def field_jit(scene: Scene, points: jax.Array) -> jax.Array:
    return field(scene, points)


def field_image(scene: Scene, axis: int, coord: float,
                width: int = 128, height: int = 128) -> jax.Array:
    """2-D field slice for debugging (reference ComputeFieldImage,
    Polygonizer.cl:1288-1325): sample the plane `axis`=coord across the
    scene bbox -> [height, width] field values."""
    lo, hi = scene.bbox_lo, scene.bbox_hi
    axes = [a for a in range(3) if a != axis]
    us = jnp.linspace(lo[axes[0]], hi[axes[0]], width)
    vs = jnp.linspace(lo[axes[1]], hi[axes[1]], height)
    uu, vv = jnp.meshgrid(us, vs)
    pts = jnp.zeros((height, width, 3))
    pts = pts.at[..., axes[0]].set(uu)
    pts = pts.at[..., axes[1]].set(vv)
    pts = pts.at[..., axis].set(coord)
    return field(scene, pts.reshape(-1, 3)).reshape(height, width)


def off_surface_points_and_fields(scene: Scene, points: jax.Array,
                                  offset: float = 0.1):
    """+/- normal offset samples with their field values (reference
    ComputeOffSurfacePointsAndFields, Polygonizer.cl:1329-1350) — the
    RBF training-data generator, with autodiff normals."""
    n = normal(scene, points)
    p_out = points + offset * n
    p_in = points - offset * n
    return (
        jnp.concatenate([p_out, p_in], 0),
        jnp.concatenate([field(scene, p_out), field(scene, p_in)], 0),
    )
