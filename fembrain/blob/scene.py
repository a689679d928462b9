"""BlobTree scene model: host-side definition + device pytree.

Replaces the reference's `LinearBlobTree` flat float-array layout
(reference: src/implicit/LinearBlobTree.h:112-221) with a typed, padded
structure-of-arrays pytree. Instead of the reference's stackless
next-pointer traversal route (src/implicit/LinearBlobTree.cpp:333-429) we
precompute a *topological operator schedule* at load time; field evaluation
is then a fixed-length scan over that schedule with an operator-value
register file, which is vectorizable over points and differentiable.

Warp operators (twist/taper/bend/shear) are pass-through stubs in the
reference (src/implicit/Polygonizer.cpp:2048-2063); here they are realized
properly as per-primitive coordinate-warp chains collected from each
primitive's root path at load time.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field as dc_field
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from .types import MAX_TREE_NODES, ISO_VALUE, OpType, PrimType
from ..utils.affine import compose_trs, map_affine

_WARP_TYPES = (OpType.WARP_TWIST, OpType.WARP_TAPER, OpType.WARP_BEND, OpType.WARP_SHEAR)


class OpWire(NamedTuple):
    """Static wiring of one operator — hashable scene metadata so the op
    fold unrolls at trace time into a pure dataflow graph (replaces the
    reference's runtime traversal route, LinearBlobTree.cpp:333-429)."""

    otype: int
    left: int
    right: int
    left_is_op: bool
    right_is_op: bool
    is_range: bool
    is_unary: bool


class WarpWire(NamedTuple):
    """Static wiring of one warp op in a primitive's warp chain."""

    op_idx: int   # index into op_params for the (traced) warp parameters
    wtype: int
    axis_a: int
    axis_b: int


# =====================================================================
# Host-side scene definition
# =====================================================================
@dataclass
class PrimDef:
    """One skeletal primitive (reference SOABlobPrims, Polygonizer.h:100-141)."""

    ptype: PrimType
    pos: np.ndarray = dc_field(default_factory=lambda: np.zeros(3))
    dir: np.ndarray = dc_field(default_factory=lambda: np.zeros(3))
    res: np.ndarray = dc_field(default_factory=lambda: np.zeros(4))
    color: np.ndarray = dc_field(default_factory=lambda: np.ones(4))
    fwd: np.ndarray = dc_field(default_factory=lambda: np.eye(4))
    bwd: np.ndarray = dc_field(default_factory=lambda: np.eye(4))
    # For INSTANCE prims only: resolved SOA index + kind of the origin node.
    instance_origin: int = -1
    instance_origin_is_op: bool = False
    # Original (scale, rotate-quat, translate) for .blob round-tripping.
    affine: tuple | None = None


@dataclass
class OpDef:
    """One BlobTree operator (reference SOABlobOps, Polygonizer.h:147-173)."""

    otype: OpType
    left: int = -1            # SOA index: op index if left_is_op else prim index
    right: int = -1
    left_is_op: bool = False
    right_is_op: bool = False
    is_range: bool = False    # left..right is an inclusive prim-index range
    is_unary: bool = False
    params: np.ndarray = dc_field(default_factory=lambda: np.zeros(4))


@dataclass
class SceneDef:
    """Host-side BlobTree; mutable, NumPy-backed. Build via blob.reader or API."""

    prims: list[PrimDef] = dc_field(default_factory=list)
    ops: list[OpDef] = dc_field(default_factory=list)
    root_is_op: bool = False
    root_idx: int = 0
    name: str = "scene"

    # ------------------------------------------------------------- construction
    # The reference caps *authored* nodes at 1024 (Polygonizer.h:71-72);
    # instance flattening can legitimately expand well beyond that (the
    # piza stress scenes), so the flat capacity is larger.
    MAX_FLAT_NODES = 1 << 16

    def add_prim(self, prim: PrimDef) -> int:
        if len(self.prims) >= self.MAX_FLAT_NODES:
            raise ValueError("prim capacity exceeded (MAX_FLAT_NODES)")
        self.prims.append(prim)
        return len(self.prims) - 1

    def add_op(self, op: OpDef) -> int:
        if len(self.ops) >= self.MAX_FLAT_NODES:
            raise ValueError("op capacity exceeded (MAX_FLAT_NODES)")
        self.ops.append(op)
        return len(self.ops) - 1

    # ------------------------------------------------------------- instances
    def flatten_instances(self) -> None:
        """Materialize INSTANCE prims by copying their origin subtree.

        The reference GPU path simply returns 0 for instanced nodes
        (data/opencl/Polygonizer.cl:505-531, disabled code); we instead unroll
        instances at load time, composing the instance transform into every
        copied primitive, which preserves static shapes and full semantics.
        """
        while True:
            idx = next(
                (i for i, p in enumerate(self.prims) if p.ptype == PrimType.INSTANCE),
                None,
            )
            if idx is None:
                return
            inst = self.prims[idx]
            origin, origin_is_op = inst.instance_origin, inst.instance_origin_is_op
            if origin < 0:
                # Unresolvable instance: degrade to NULL (field 0), like reference.
                self.prims[idx] = PrimDef(PrimType.NULL)
                continue
            if not origin_is_op:
                src = self.prims[origin]
                # Instance-of-instance: the composed copy keeps its origin
                # reference and is resolved on a later sweep of the loop.
                self.prims[idx] = _compose_prim(src, inst)
            else:
                # Copy the op subtree; the instance prim slot becomes NULL and a
                # new root-side op is NOT needed: we replace the instance's
                # *parent reference*. Simpler: copy subtree, then rewrite every
                # op child reference that pointed at prim idx to point at the
                # new op (as an op child).
                new_op = self._copy_op_subtree(origin, inst)
                self.prims[idx] = PrimDef(PrimType.NULL)
                for op in self.ops:
                    if not op.is_range:
                        if not op.left_is_op and op.left == idx:
                            op.left, op.left_is_op = new_op, True
                        if not op.is_unary and not op.right_is_op and op.right == idx:
                            op.right, op.right_is_op = new_op, True
                if not self.root_is_op and self.root_idx == idx:
                    self.root_is_op, self.root_idx = True, new_op

    def _copy_op_subtree(self, idx_op: int, inst: PrimDef) -> int:
        src = self.ops[idx_op]
        new = OpDef(
            otype=src.otype,
            is_range=src.is_range,
            is_unary=src.is_unary,
            params=src.params.copy(),
        )
        if src.is_range:
            lo, hi = src.left, src.right
            new_prims = [_compose_prim(self.prims[i], inst) for i in range(lo, hi + 1)]
            base = len(self.prims)
            for p in new_prims:
                self.add_prim(p)
            new.left, new.right = base, base + len(new_prims) - 1
        else:
            if src.left_is_op:
                new.left, new.left_is_op = self._copy_op_subtree(src.left, inst), True
            else:
                new.left = self.add_prim(_compose_prim(self.prims[src.left], inst))
            if not src.is_unary:
                if src.right_is_op:
                    new.right, new.right_is_op = (
                        self._copy_op_subtree(src.right, inst),
                        True,
                    )
                else:
                    new.right = self.add_prim(
                        _compose_prim(self.prims[src.right], inst)
                    )
        return self.add_op(new)

    # ------------------------------------------------------------- schedule
    def topo_schedule(self) -> list[int]:
        """Children-first (post-order) op evaluation order from the root."""
        if not self.root_is_op:
            return []
        order: list[int] = []
        seen: set[int] = set()

        def visit(i: int) -> None:
            if i in seen:
                return
            seen.add(i)
            op = self.ops[i]
            if not op.is_range:
                if op.left_is_op:
                    visit(op.left)
                if not op.is_unary and op.right_is_op:
                    visit(op.right)
            order.append(i)

        visit(self.root_idx)
        return order

    def warp_chains(self) -> list[list[tuple[int, OpType, np.ndarray]]]:
        """Per-prim chain of (op_idx, op_type, params) warp ops on the prim's
        root path (root-first)."""
        chains: list[list[tuple[int, OpType, np.ndarray]]] = [[] for _ in self.prims]
        if not self.root_is_op:
            return chains

        def walk(i: int, warps: list[tuple[int, OpType, np.ndarray]]) -> None:
            op = self.ops[i]
            w = warps + (
                [(i, op.otype, op.params)] if op.otype in _WARP_TYPES else []
            )
            if op.is_range:
                for p in range(op.left, op.right + 1):
                    chains[p] = list(w)
                return
            if op.left_is_op:
                walk(op.left, w)
            elif op.left >= 0:
                chains[op.left] = list(w)
            if not op.is_unary:
                if op.right_is_op:
                    walk(op.right, w)
                elif op.right >= 0:
                    chains[op.right] = list(w)

        walk(self.root_idx, [])
        return chains

    # ------------------------------------------------------------- bounds
    def prim_aabb(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Primitive AABB (reference LinearBlobTree::computePrimAABB,
        src/implicit/LinearBlobTree.cpp:607-748)."""
        p = self.prims[i]
        off = ISO_VALUE
        pos, d, res = p.pos, p.dir, p.res
        t = p.ptype
        if t in (PrimType.POINT, PrimType.NULL):
            lo, hi = pos - off, pos + off
        elif t == PrimType.LINE:
            expand = off + 3.0 * off * (d - pos)
            lo, hi = pos - expand, d + expand
        elif t in (PrimType.RING, PrimType.DISC):
            r = res[0] + off
            expand = (r + off) * (1.0 - d) + off * d
            lo, hi = pos - expand, pos + expand
        elif t == PrimType.CYLINDER:
            r, h = res[0], res[1]
            s1 = pos + h * d
            expand = (off + r) + 0.5 * off * d
            lo, hi = pos - expand, s1 + expand
        elif t == PrimType.CUBE:
            side = res[0] + off
            lo, hi = pos - side, pos + side
        elif t == PrimType.TRIANGLE:
            pts = np.stack([pos, d, res[:3]])
            lo, hi = pts.min(0) - off, pts.max(0) + off
        elif t == PrimType.QUADRIC_POINT:
            w = d[1] + off
            lo, hi = pos - w, pos + w
        else:  # INSTANCE (resolved elsewhere) / RBF
            lo = hi = np.zeros(3)
        loT = map_affine(p.fwd, lo)
        hiT = map_affine(p.fwd, hi)
        return np.minimum(loT, hiT), np.maximum(loT, hiT)

    def aabb(self) -> tuple[np.ndarray, np.ndarray]:
        """Whole-scene AABB: union of primitive boxes (conservative — the
        reference unions child boxes per op too, LinearBlobTree.cpp:750-876)."""
        if not self.prims:
            return np.zeros(3), np.zeros(3)
        los, his = zip(*(self.prim_aabb(i) for i in range(len(self.prims))))
        return np.min(np.stack(los), 0), np.max(np.stack(his), 0)

    def prim_support_aabb(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Guaranteed world-space superset of primitive i's field support.

        Unlike `prim_aabb` (which mirrors the reference's per-type box
        heuristics for parity), this inflates the local skeleton bbox by
        the full Wyvill support radius (local d^2 < 1 => field = 0 outside)
        and maps the box through the forward affine with the |A|-half-width
        rule, so it is safe for ray-interval culling: outside the union of
        these boxes every primitive field — and hence any op fold, which is
        bounded above by the sum of primitive fields — is exactly zero.
        """
        p = self.prims[i]
        pos, d, res = p.pos, p.dir, p.res
        t = p.ptype
        big = 1e8
        if t == PrimType.POINT:
            lo, hi = pos - 1.0, pos + 1.0
        elif t == PrimType.LINE:
            lo, hi = np.minimum(pos, d) - 1.0, np.maximum(pos, d) + 1.0
        elif t == PrimType.CYLINDER:
            s1 = pos + res[1] * d
            e = res[0] + 1.0
            lo, hi = np.minimum(pos, s1) - e, np.maximum(pos, s1) + e
        elif t in (PrimType.DISC, PrimType.RING):
            e = res[0] + 1.0
            lo, hi = pos - e, pos + e
        elif t == PrimType.CUBE:
            e = res[0] + 1.0
            lo, hi = pos - e, pos + e
        elif t == PrimType.TRIANGLE:
            pts = np.stack([pos, d, res[:3]])
            lo, hi = pts.min(0) - 1.0, pts.max(0) + 1.0
        elif t == PrimType.QUADRIC_POINT:
            # Polynomial branch is active for dd < dir[2]; beyond that the
            # Wyvill branch needs dd < 1 (ops/field.py quadric handling).
            e = max(1.0, float(np.sqrt(max(float(d[2]), 0.0))))
            lo, hi = pos - e, pos + e
        elif t == PrimType.NULL:
            return np.full(3, big), np.full(3, -big)  # empty: no field
        else:  # unbounded/unknown (RBF): never cull
            return np.full(3, -big), np.full(3, big)
        c = 0.5 * (lo + hi)
        h = 0.5 * (hi - lo)
        A, b = p.fwd[:3, :3], p.fwd[:3, 3]
        cw = A @ c + b
        hw = np.abs(A) @ h
        return cw - hw, cw + hw

    # ------------------------------------------------------------- checks
    def validate(self) -> list[str]:
        """BlobTree structural checks (reference CheckForBlobTreeErrors,
        src/implicit/Polygonizer.h:463-471: child indices valid, each op
        referenced at most once, ranges well-formed). Returns violations."""
        errors: list[str] = []
        op_refs: dict[int, int] = {}
        for i, op in enumerate(self.ops):
            if op.is_range:
                if not (0 <= op.left <= op.right < len(self.prims)):
                    errors.append(f"op {i}: bad range [{op.left},{op.right}]")
                continue
            for child, is_op, label in (
                (op.left, op.left_is_op, "left"),
                (op.right, op.right_is_op, "right"),
            ):
                if label == "right" and op.is_unary:
                    continue
                n = len(self.ops) if is_op else len(self.prims)
                if not (0 <= child < n):
                    errors.append(f"op {i}: bad {label} child {child}")
                elif is_op:
                    op_refs[child] = op_refs.get(child, 0) + 1
        for child, count in op_refs.items():
            if count > 1:
                errors.append(f"op {child}: referenced {count} times")
        if self.root_is_op and not (0 <= self.root_idx < len(self.ops)):
            errors.append(f"bad root op {self.root_idx}")
        return errors

    # ------------------------------------------------------------- packing
    def pack(self, pad_prims: int | None = None, pad_ops: int | None = None) -> "Scene":
        """Pack into the padded, static-shape device pytree."""
        self.flatten_instances()
        n_p, n_o = len(self.prims), len(self.ops)
        P = pad_prims or max(8, _round_up(n_p, 8))
        O = pad_ops or max(1, n_o)
        if P < n_p or O < n_o:
            raise ValueError("padding smaller than scene")

        prim_type = np.full(P, int(PrimType.NULL), np.int32)
        prim_mtx = np.tile(np.eye(4)[:3].astype(np.float32), (P, 1, 1))
        prim_pos = np.zeros((P, 3), np.float32)
        prim_dir = np.zeros((P, 3), np.float32)
        prim_res = np.zeros((P, 4), np.float32)
        prim_color = np.zeros((P, 4), np.float32)
        for i, p in enumerate(self.prims):
            prim_type[i] = int(p.ptype)
            prim_mtx[i] = p.bwd[:3].astype(np.float32)
            prim_pos[i] = p.pos
            prim_dir[i] = p.dir
            prim_res[i] = p.res
            prim_color[i] = p.color

        chains = self.warp_chains()
        W = max(1, max((len(c) for c in chains), default=0))
        warp_type = np.full((P, W), -1, np.int32)
        warp_params = np.zeros((P, W, 4), np.float32)
        for i, chain in enumerate(chains):
            for j, (_, wt, wp) in enumerate(chain):
                warp_type[i, j] = int(wt)
                warp_params[i, j] = wp

        # Static warp groups: prims sharing an identical warp chain are
        # evaluated together; scenes without warps get one empty-chain group.
        def chain_wire(chain) -> tuple[WarpWire, ...]:
            wires = []
            for op_idx, wt, wp in chain:
                if wt in (OpType.WARP_TWIST,):
                    aa, ab = int(wp[1]), 0
                elif wt in (OpType.WARP_TAPER, OpType.WARP_SHEAR):
                    aa, ab = int(wp[1]), int(wp[2])
                else:  # bend: no axis params
                    aa, ab = 0, 0
                wires.append(WarpWire(op_idx, int(wt), aa, ab))
            return tuple(wires)

        groups: dict[tuple[WarpWire, ...], list[int]] = {}
        for i in range(n_p):
            groups.setdefault(chain_wire(chains[i]), []).append(i)
        if not groups:
            groups[()] = []
        warp_groups = tuple(
            (wire, tuple(prims)) for wire, prims in groups.items()
        )

        op_type = np.zeros(O, np.int32)
        op_left = np.zeros(O, np.int32)
        op_right = np.zeros(O, np.int32)
        op_left_is_op = np.zeros(O, np.int32)
        op_right_is_op = np.zeros(O, np.int32)
        op_is_range = np.zeros(O, np.int32)
        op_is_unary = np.zeros(O, np.int32)
        op_params = np.zeros((O, 4), np.float32)
        for i, o in enumerate(self.ops):
            op_type[i] = int(o.otype)
            op_left[i], op_right[i] = o.left, o.right
            op_left_is_op[i] = int(o.left_is_op)
            op_right_is_op[i] = int(o.right_is_op)
            op_is_range[i] = int(o.is_range)
            op_is_unary[i] = int(o.is_unary)
            op_params[i] = o.params

        sched = self.topo_schedule()
        op_schedule = np.full(O, -1, np.int32)
        op_schedule[: len(sched)] = sched

        wiring = tuple(
            OpWire(
                int(o.otype),
                int(o.left),
                int(o.right),
                bool(o.left_is_op),
                bool(o.right_is_op),
                bool(o.is_range),
                bool(o.is_unary),
            )
            for o in self.ops
        )
        fold_plan, fold_registers, root_reg = _alloc_fold_plan(wiring, sched)

        lo, hi = self.aabb()
        bb_lo = np.full((P, 3), 1e8, np.float32)
        bb_hi = np.full((P, 3), -1e8, np.float32)
        for i in range(n_p):
            bb_lo[i], bb_hi[i] = self.prim_support_aabb(i)
        scene = Scene(
            prim_type=jnp.asarray(prim_type),
            prim_mtx=jnp.asarray(prim_mtx),
            prim_pos=jnp.asarray(prim_pos),
            prim_dir=jnp.asarray(prim_dir),
            prim_res=jnp.asarray(prim_res),
            prim_color=jnp.asarray(prim_color),
            warp_type=jnp.asarray(warp_type),
            warp_params=jnp.asarray(warp_params),
            op_type=jnp.asarray(op_type),
            op_left=jnp.asarray(op_left),
            op_right=jnp.asarray(op_right),
            op_left_is_op=jnp.asarray(op_left_is_op),
            op_right_is_op=jnp.asarray(op_right_is_op),
            op_is_range=jnp.asarray(op_is_range),
            op_is_unary=jnp.asarray(op_is_unary),
            op_params=jnp.asarray(op_params),
            op_schedule=jnp.asarray(op_schedule),
            bbox_lo=jnp.asarray(lo, jnp.float32),
            bbox_hi=jnp.asarray(hi, jnp.float32),
            prim_bb_lo=jnp.asarray(bb_lo),
            prim_bb_hi=jnp.asarray(bb_hi),
            n_prims=n_p,
            n_ops=n_o,
            root_is_op=self.root_is_op,
            root_idx=self.root_idx,
            wiring=wiring,
            schedule=tuple(sched),
            warp_groups=warp_groups,
            fold_plan=fold_plan,
            fold_registers=fold_registers,
            root_reg=root_reg,
            prim_types_present=tuple(
                sorted({int(p.ptype) for p in self.prims})
            ),
            monotone_field=all(
                o.otype in (OpType.UNION, OpType.BLEND, OpType.RICCI_BLEND,
                            OpType.GRADIENT_BLEND,
                            OpType.FAST_QUADRIC_POINT_SET, OpType.CACHE)
                for o in self.ops
            ),
            max_world_to_local_scale=float(
                max(
                    (np.linalg.norm(p.bwd[:3, :3], 2) for p in self.prims),
                    default=1.0,
                )
            ),
        )
        return _normalize_additive(scene)


def _morton_code(centers: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """30-bit Morton codes for [P, 3] points inside [lo, hi]."""
    qn = np.clip((centers - lo) / np.maximum(hi - lo, 1e-6), 0.0, 1.0)
    q = (qn * 1023.0).astype(np.uint32)

    def spread(x):
        x = (x | (x << 16)) & np.uint32(0x030000FF)
        x = (x | (x << 8)) & np.uint32(0x0300F00F)
        x = (x | (x << 4)) & np.uint32(0x030C30C3)
        x = (x | (x << 2)) & np.uint32(0x09249249)
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def _normalize_additive(scene: Scene) -> Scene:
    """Canonicalize additive scenes (every op a sum-fold, each prim used
    once — the dominant blobby-anatomy case) at pack time:

    * primitives are Morton-ordered by support-box center, so spatially
      close prims share PRIM_BLOCK rows in the Pallas tracer and per-tile
      culling skips dense, coherent blocks;
    * the whole operator tree collapses to ONE range BLEND over all prims
      (semantically identical — sums are order-free, and color is a
      field-weighted sum, ops.field.field_and_color);
    * per-block present-type sets become static metadata so the tracer
      emits only the distance branches each block actually needs (brain:
      162 points + 1 cylinder no longer pays the cylinder path in every
      block).
    """
    if not scene.is_additive or scene.n_prims < 2:
        return scene
    P = scene.capacity_prims
    block = 8  # render.pallas_trace.PRIM_BLOCK
    if P % block:
        return scene

    bb_lo = np.asarray(scene.prim_bb_lo)
    bb_hi = np.asarray(scene.prim_bb_hi)
    centers = 0.5 * (bb_lo + bb_hi)
    code = _morton_code(
        centers, np.asarray(scene.bbox_lo), np.asarray(scene.bbox_hi)
    )
    code[scene.n_prims:] = np.uint32(0xFFFFFFFF)  # padding rows sort last
    perm = np.argsort(code, kind="stable")

    def take(a):
        return jnp.asarray(np.asarray(a)[perm])

    types = np.asarray(scene.prim_type)[perm]
    block_types = tuple(
        tuple(sorted({int(t) for t in types[b : b + block]
                      if t != int(PrimType.NULL)}))
        for b in range(0, P, block)
    )

    scene = dataclasses.replace(
        scene,
        prim_type=take(scene.prim_type),
        prim_mtx=take(scene.prim_mtx),
        prim_pos=take(scene.prim_pos),
        prim_dir=take(scene.prim_dir),
        prim_res=take(scene.prim_res),
        prim_color=take(scene.prim_color),
        warp_type=take(scene.warp_type),
        warp_params=take(scene.warp_params),
        prim_bb_lo=take(scene.prim_bb_lo),
        prim_bb_hi=take(scene.prim_bb_hi),
        warp_groups=(((), tuple(range(scene.n_prims))),),
        additive_block_types=block_types,
    )
    if not scene.root_is_op:
        return scene  # op-free sum: reorder is all that's needed

    # One range BLEND over all prims replaces the op tree (sums are
    # order-free, so the collapsed form is semantically identical).
    O = scene.capacity_ops
    op_type = np.zeros(O, np.int32)
    op_type[0] = int(OpType.BLEND)
    op_left = np.zeros(O, np.int32)
    op_right = np.zeros(O, np.int32)
    op_right[0] = scene.n_prims - 1
    op_is_range = np.zeros(O, np.int32)
    op_is_range[0] = 1
    op_schedule = np.full(O, -1, np.int32)
    op_schedule[0] = 0
    wiring = (
        OpWire(int(OpType.BLEND), 0, scene.n_prims - 1, False, False,
               True, False),
    ) + tuple(
        OpWire(int(OpType.BLEND), 0, 0, False, False, False, True)
        for _ in range(O - 1)
    )
    sched = [0]
    fold_plan, fold_registers, root_reg = _alloc_fold_plan(wiring, sched)

    return dataclasses.replace(
        scene,
        op_type=jnp.asarray(op_type),
        op_left=jnp.asarray(op_left),
        op_right=jnp.asarray(op_right),
        op_left_is_op=jnp.zeros(O, jnp.int32),
        op_right_is_op=jnp.zeros(O, jnp.int32),
        op_is_range=jnp.asarray(op_is_range),
        op_is_unary=jnp.zeros(O, jnp.int32),
        op_params=jnp.zeros((O, 4), jnp.float32),
        op_schedule=jnp.asarray(op_schedule),
        n_ops=1,
        root_is_op=True,
        root_idx=0,
        wiring=wiring,
        schedule=(0,),
        fold_plan=fold_plan,
        fold_registers=fold_registers,
        root_reg=root_reg,
    )


def _compose_prim(src: PrimDef, inst: PrimDef) -> PrimDef:
    """Copy `src` with the instance transform composed in.

    Query points go world -> instance-local -> prim-local, so the combined
    backward matrix is ``src.bwd @ inst.bwd``.
    """
    return PrimDef(
        ptype=src.ptype,
        pos=src.pos.copy(),
        dir=src.dir.copy(),
        res=src.res.copy(),
        color=src.color.copy(),
        fwd=inst.fwd @ src.fwd,
        bwd=src.bwd @ inst.bwd,
        instance_origin=src.instance_origin,
        instance_origin_is_op=src.instance_origin_is_op,
    )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Operand-source kinds in the fold plan.
SRC_REG = 0     # operator register
SRC_PRIM = 1    # primitive field column
SRC_RANGE = 2   # precomputed range-op value slot
SRC_ZERO = 3    # constant zero (unary rf)


def _alloc_fold_plan(
    wiring: tuple, sched: list[int]
) -> tuple[tuple, int, int]:
    """Linear-scan register allocation over the topo schedule.

    Produces a uniform step plan for `lax.scan`-based folding on large
    scenes: each step is (op_idx, op_type, dst_reg, l_kind, l_idx, r_kind,
    r_idx). Register count equals the max number of simultaneously-live
    operator values — bounded by tree depth, tiny in practice — so the scan
    carry is [R, N] instead of the O(n_ops * N) register file a naive fold
    would need.
    """
    if not sched:
        return (), 1, 0

    # Range ops get precomputed slots in schedule order.
    range_slot = {k: i for i, k in enumerate(
        [k for k in sched if wiring[k].is_range]
    )}

    # Last position each op's value is consumed. The BlobTree is a tree
    # (each op referenced by exactly one parent), so a child's value dies
    # at its parent's step; the root lives to the end.
    pos = {k: i for i, k in enumerate(sched)}
    last_use = {k: len(sched) for k in sched}
    for k in sched:
        w = wiring[k]
        if not w.is_range:
            if w.left_is_op:
                last_use[w.left] = pos[k]
            if not w.is_unary and w.right_is_op:
                last_use[w.right] = pos[k]
    root = sched[-1]
    last_use[root] = len(sched)

    free: list[int] = []
    next_reg = 0
    reg_of: dict[int, int] = {}
    plan = []
    for i, k in enumerate(sched):
        w = wiring[k]
        if w.is_range:
            lk, li = SRC_RANGE, range_slot[k]
            rk, ri = SRC_ZERO, 0
        else:
            if w.left_is_op:
                lk, li = SRC_REG, reg_of[w.left]
            else:
                lk, li = SRC_PRIM, w.left
            if w.is_unary:
                rk, ri = SRC_ZERO, 0
            elif w.right_is_op:
                rk, ri = SRC_REG, reg_of[w.right]
            else:
                rk, ri = SRC_PRIM, w.right
            # Free operand registers whose value dies at this step.
            for child in ((w.left,) if w.left_is_op else ()) + (
                (w.right,) if (not w.is_unary and w.right_is_op) else ()
            ):
                if last_use[child] == i:
                    free.append(reg_of.pop(child))
        if free:
            dst = free.pop()
        else:
            dst = next_reg
            next_reg += 1
        reg_of[k] = dst
        plan.append((k, w.otype, dst, lk, li, rk, ri))
    return tuple(plan), max(1, next_reg), reg_of[root]


# =====================================================================
# Device-side pytree
# =====================================================================
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """Padded, static-shape BlobTree scene (device pytree).

    Array fields are leaves (differentiable where float); counts and root
    info are static metadata so jitted code specializes per scene shape.
    """

    prim_type: jax.Array
    prim_mtx: jax.Array      # [P, 3, 4] world->local (backward) matrices
    prim_pos: jax.Array      # [P, 3]
    prim_dir: jax.Array      # [P, 3]
    prim_res: jax.Array      # [P, 4]
    prim_color: jax.Array    # [P, 4]
    warp_type: jax.Array     # [P, W] (-1 = none), root-first warp chain
    warp_params: jax.Array   # [P, W, 4]
    op_type: jax.Array       # [O]
    op_left: jax.Array
    op_right: jax.Array
    op_left_is_op: jax.Array
    op_right_is_op: jax.Array
    op_is_range: jax.Array
    op_is_unary: jax.Array
    op_params: jax.Array     # [O, 4]
    op_schedule: jax.Array   # [O] topo order, -1 padded
    bbox_lo: jax.Array       # [3]
    bbox_hi: jax.Array       # [3]
    # Conservative per-prim support boxes (empty box = +/-1e8 for padding);
    # the ray-interval culling oracle (see SceneDef.prim_support_aabb).
    prim_bb_lo: jax.Array    # [P, 3]
    prim_bb_hi: jax.Array    # [P, 3]
    n_prims: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_ops: int = dataclasses.field(metadata=dict(static=True), default=0)
    root_is_op: bool = dataclasses.field(metadata=dict(static=True), default=False)
    root_idx: int = dataclasses.field(metadata=dict(static=True), default=0)
    # Static wiring: hashable scene topology; jitted evaluators specialize
    # on these (the op fold unrolls into a dataflow graph at trace time).
    wiring: tuple = dataclasses.field(metadata=dict(static=True), default=())
    schedule: tuple = dataclasses.field(metadata=dict(static=True), default=())
    warp_groups: tuple = dataclasses.field(metadata=dict(static=True), default=())
    prim_types_present: tuple = dataclasses.field(
        metadata=dict(static=True), default=()
    )
    # Register-allocated fold plan for lax.scan evaluation of large scenes.
    fold_plan: tuple = dataclasses.field(metadata=dict(static=True), default=())
    fold_registers: int = dataclasses.field(metadata=dict(static=True), default=1)
    root_reg: int = dataclasses.field(metadata=dict(static=True), default=0)
    # True when the total field is >= every primitive's field (unions /
    # blends only, no warps): the Wyvill support radius then gives a safe
    # sphere-tracing step bound. DIF/INTERSECT scenes march fixed steps.
    monotone_field: bool = dataclasses.field(
        metadata=dict(static=True), default=False
    )
    # Conservative world->local stretch: max spectral norm over prim
    # inverse matrices; safe world step = local bound / this.
    max_world_to_local_scale: float = dataclasses.field(
        metadata=dict(static=True), default=1.0
    )
    # For pack-normalized additive scenes (see _normalize_additive):
    # per-PRIM_BLOCK present primitive-type tuples, in Morton order.
    # Empty tuple = not normalized.
    additive_block_types: tuple = dataclasses.field(
        metadata=dict(static=True), default=()
    )

    @property
    def capacity_prims(self) -> int:
        return self.prim_type.shape[0]

    @property
    def can_cull(self) -> bool:
        """Whether per-prim support boxes bound the field (no warps: warp
        chains move evaluation points, so unwarped boxes don't bound the
        warped support)."""
        return len(self.warp_groups) == 1 and not self.warp_groups[0][0]

    @property
    def capacity_ops(self) -> int:
        return self.op_type.shape[0]

    @property
    def is_additive(self) -> bool:
        """True when the total field is EXACTLY the sum of all primitive
        fields: no warps, every operator is a sum-fold (BLEND family), and
        each real primitive / interior op feeds exactly one parent. Blobby
        anatomy scenes (brain, ventricle, tumor: one root BLEND) are all
        additive, which licenses order-free evaluation — the basis for the
        per-tile primitive culling in the Pallas tracer."""
        if not self.can_cull:
            return False
        if not self.root_is_op:
            return True  # ops.field sums all prims in this case
        sum_ops = (
            int(OpType.BLEND),
            int(OpType.GRADIENT_BLEND),
            int(OpType.FAST_QUADRIC_POINT_SET),
        )
        prim_refs = [0] * self.n_prims
        op_refs = {k: 0 for k in self.schedule}
        for k in self.schedule:
            w = self.wiring[k]
            if w.otype not in sum_ops:
                return False
            if w.is_range:
                if w.right >= self.n_prims:
                    return False
                for i in range(w.left, w.right + 1):
                    prim_refs[i] += 1
            else:
                if w.left_is_op:
                    op_refs[w.left] += 1
                elif w.left < self.n_prims:
                    prim_refs[w.left] += 1
                else:
                    return False
                if not w.is_unary:
                    if w.right_is_op:
                        op_refs[w.right] += 1
                    elif w.right < self.n_prims:
                        prim_refs[w.right] += 1
                    else:
                        return False
        interior_ok = all(
            op_refs[k] == (0 if k == self.root_idx else 1)
            for k in self.schedule
        )
        return interior_ok and all(r == 1 for r in prim_refs)
