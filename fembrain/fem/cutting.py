"""Progressive tetrahedral mesh cutting.

Port of the reference's cutting stack (CuttableMesh::cut,
src/deformable/CuttableMesh.cpp:283-482 + TetSubdivider,
src/deformable/TetSubdivider.{h,cpp}): scalpel swept-quads are intersected
against every mesh edge, cut cells are classified by their 6-bit
cutEdgeCode, and supported cases are re-tessellated after `cut_edge`
splits. The reference enumerates cases A (3 edges around one corner ->
4 sub-tets) and B (4 edges slicing 2+2 corners -> 6 sub-tets) via
hand-built tables (TetSubdivider.cpp:21-44) and refuses anything else
(CuttableMesh.cpp:381-387); here both cases are handled by one generic
*component* construction — remove cut edges from the tet graph, require
exactly two connected corner components, and tetrahedralize each component
polyhedron (corner/wedge/prism) — which reproduces the A and B tables and
generalizes cleanly. Orientation is fixed by signed volume.

Like the reference, topology mutation happens on the host and the FEM
solver stack is rebuilt afterwards (Deformable::syncForceModel).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..mesh.volmesh import CELL_EDGES, VolMesh


class CutError(RuntimeError):
    pass


# ----------------------------------------------------------------- intersect
def segment_triangle_intersect(p0, p1, a, b, c, eps=1e-12):
    """Segment vs triangle (Moller-Trumbore); returns t in [0,1] along the
    segment or None (reference Cutting.cl:59-102 / Intersections.h)."""
    d = p1 - p0
    e1 = b - a
    e2 = c - a
    h = np.cross(d, e2)
    det = np.dot(e1, h)
    if abs(det) < eps:
        return None
    inv = 1.0 / det
    s = p0 - a
    u = np.dot(s, h) * inv
    if u < -1e-9 or u > 1 + 1e-9:
        return None
    q = np.cross(s, e1)
    v = np.dot(d, q) * inv
    if v < -1e-9 or u + v > 1 + 1e-9:
        return None
    t = np.dot(e2, q) * inv
    if t < -1e-9 or t > 1 + 1e-9:
        return None
    return float(np.clip(t, 0.0, 1.0))


def segment_quad_intersect(p0, p1, quad):
    """Segment vs quad (two triangles); returns t along segment or None."""
    q0, q1, q2, q3 = quad
    t = segment_triangle_intersect(p0, p1, q0, q1, q2)
    if t is None:
        t = segment_triangle_intersect(p0, p1, q0, q2, q3)
    return t


def _batched_seg_tri(p0, p1, a, b, c, eps=1e-12):
    """Vectorized Moller-Trumbore: segments [E,1,3] vs triangles [1,K,3]
    (or any broadcastable shapes) -> (valid [E,K], t [E,K]). The batched
    analog of the reference's GPU cut kernels (Cutting.cl:59-102)."""
    import jax.numpy as jnp

    d = p1 - p0
    e1 = b - a
    e2 = c - a
    h = jnp.cross(d, e2)
    det = jnp.sum(e1 * h, -1)
    inv = 1.0 / jnp.where(jnp.abs(det) < eps, eps, det)
    s = p0 - a
    u = jnp.sum(s * h, -1) * inv
    q = jnp.cross(s, e1)
    v = jnp.sum(d * q, -1) * inv
    t = jnp.sum(e2 * q, -1) * inv
    # f32 barycentric tolerance: crossings on the quad's internal diagonal
    # (shared edge of its two triangles) must not fall between the two
    # triangles' exclusion zones (the scalar f64 path uses 1e-9).
    tol = 1e-5
    valid = (
        (jnp.abs(det) >= eps)
        & (u >= -tol) & (u <= 1 + tol)
        & (v >= -tol) & (u + v <= 1 + tol)
        & (t >= -1e-9) & (t <= 1 + 1e-9)
    )
    return valid, jnp.clip(t, 0.0, 1.0)


def _edge_quad_hits_jit():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(p0, p1, quads):
        P0 = p0[:, None, :]                    # [E,1,3]
        P1 = p1[:, None, :]
        # Quad = two triangles (q0,q1,q2) and (q0,q2,q3).
        v1, t1 = _batched_seg_tri(P0, P1, quads[None, :, 0],
                                  quads[None, :, 1], quads[None, :, 2])
        v2, t2 = _batched_seg_tri(P0, P1, quads[None, :, 0],
                                  quads[None, :, 2], quads[None, :, 3])
        t_q = jnp.where(v1, t1, jnp.where(v2, t2, jnp.inf))  # [E,Q]
        interior = (t_q > 1e-4) & (t_q < 1 - 1e-4)
        first = jnp.argmax(interior, axis=1)                 # first quad
        hit = jnp.any(interior, axis=1)
        t = t_q[jnp.arange(t_q.shape[0]), first]
        return hit, t

    return run


_EDGE_QUAD_HITS = None


def batched_edge_quad_hits(p0: np.ndarray, p1: np.ndarray,
                           quads: np.ndarray):
    """All edges x all swept quads in one jitted pass: p0/p1 [E,3] edge
    endpoints, quads [Q,4,3]. Returns (hit [E] bool, t [E]) with t from
    the FIRST hitting quad in sweep order (matching the scalar loop's
    break-on-first semantics). Replaces the per-edge Python loop — the
    vectorized analog SURVEY 2.5 maps Cutting.cl's edge kernel to."""
    import jax.numpy as jnp

    global _EDGE_QUAD_HITS
    if _EDGE_QUAD_HITS is None:
        _EDGE_QUAD_HITS = _edge_quad_hits_jit()
    hit, t = _EDGE_QUAD_HITS(
        jnp.asarray(p0, jnp.float32),
        jnp.asarray(p1, jnp.float32),
        jnp.asarray(quads, jnp.float32),
    )
    return np.asarray(hit), np.asarray(t)


# ----------------------------------------------------------------- subdivide
def _corner_components(cut_slots: set[int]) -> list[set[int]]:
    """Connected components of the 4 corners under UNCUT edges."""
    adj = {i: set() for i in range(4)}
    for slot, (a, b) in enumerate(CELL_EDGES):
        if slot not in cut_slots:
            adj[a].add(b)
            adj[b].add(a)
    seen, comps = set(), []
    for s in range(4):
        if s in seen:
            continue
        comp, stack = set(), [s]
        while stack:
            u = stack.pop()
            if u in comp:
                continue
            comp.add(u)
            stack.extend(adj[u] - comp)
        seen |= comp
        comps.append(comp)
    return comps


def _is_complete_cut(cut_slots: set[int], comps: list[set[int]]) -> bool:
    """A supported (complete) cut yields exactly 2 corner components with
    every cut edge spanning them (cases A and B; 3 or 4 cut edges)."""
    if len(comps) != 2:
        return False
    comp_of = {}
    for ci, comp in enumerate(comps):
        for s in comp:
            comp_of[s] = ci
    return all(
        comp_of[CELL_EDGES[s][0]] != comp_of[CELL_EDGES[s][1]]
        for s in cut_slots
    )


def subdivide_cell(mesh: VolMesh, idx_cell: int,
                   cut_edges: dict[int, tuple[int, int]]) -> list[int]:
    """Subdivide one cell whose edge slots in `cut_edges` were already
    split. cut_edges: slot -> (mid node on from-side, mid node on to-side)
    where from/to follow the canonical CELL_EDGES slot order.

    Returns new cell indices; raises CutError for unsupported codes.
    """
    cell = mesh.cells[idx_cell]
    cut_slots = set(cut_edges)
    comps = _corner_components(cut_slots)
    if not _is_complete_cut(cut_slots, comps):
        # Cases C/D/E... — partial cuts, refused like the reference.
        raise CutError(
            f"cell {idx_cell}: cut slots {sorted(cut_slots)} unsupported"
        )

    new_cells: list[int] = []
    for comp in comps:
        corners = [cell.nodes[s] for s in sorted(comp)]
        # Component-side mid node of each cut edge with an endpoint here.
        mids = []
        for slot in sorted(cut_slots):
            a, b = CELL_EDGES[slot]
            if a in comp:
                mids.append((slot, a, cut_edges[slot][0]))
            elif b in comp:
                mids.append((slot, b, cut_edges[slot][1]))

        k = len(comp)
        if k == 1:
            # Corner tet: apex + its 3 mids.
            assert len(mids) == 3
            tet = [corners[0]] + [m[2] for m in mids]
            new_cells.append(_insert_oriented(mesh, tet))
        elif k == 2:
            # Wedge: corners c0, c1 (uncut edge) + 2 mids each.
            assert len(mids) == 4
            c0s, c1s = sorted(comp)
            c0, c1 = cell.nodes[c0s], cell.nodes[c1s]
            m0 = [m[2] for m in mids if m[1] == c0s]
            m1 = [m[2] for m in mids if m[1] == c1s]
            # Pair mids across the wedge by the far corner of their edge.
            def far(slot, here):
                a, b = CELL_EDGES[slot]
                return b if a == here else a
            far0 = [far(m[0], c0s) for m in mids if m[1] == c0s]
            far1 = [far(m[0], c1s) for m in mids if m[1] == c1s]
            if far0[0] != far1[0]:
                m1 = m1[::-1]
            A, B = m0
            C, D = m1
            for tet in ([c0, A, B, c1], [A, B, c1, C], [B, c1, C, D]):
                new_cells.append(_insert_oriented(mesh, tet))
        elif k == 3:
            # Prism: 3 corners + their 3 mids.
            assert len(mids) == 3
            by_corner = {m[1]: m[2] for m in mids}
            cs = sorted(comp)
            c0, c1, c2 = (cell.nodes[s] for s in cs)
            m0, m1, m2 = (by_corner[s] for s in cs)
            for tet in ([c0, c1, c2, m0], [c1, c2, m0, m1], [c2, m0, m1, m2]):
                new_cells.append(_insert_oriented(mesh, tet))
        else:
            raise CutError(f"cell {idx_cell}: component of size {k}")

    mesh.schedule_remove_cell(idx_cell)
    return new_cells


def _insert_oriented(mesh: VolMesh, tet: list[int]) -> int:
    p = [mesh.nodes[n].pos for n in tet]
    vol = np.dot(p[1] - p[0], np.cross(p[2] - p[0], p[3] - p[0]))
    if vol < 0:
        tet = [tet[0], tet[2], tet[1], tet[3]]
    return mesh.insert_cell(tet)


def snap_cut_nodes(mesh: VolMesh, cut_edge_t: dict[int, float],
                   roi: float = 0.2):
    """Cut-node snapping pre-pass (reference
    CuttableMesh::computeCutNodesKernel,
    src/deformable/CuttableMesh.cpp:214-281): when a cut
    lands within `roi` (fraction of edge length) of an edge endpoint, the
    endpoint becomes a CUT NODE and every cut edge incident to it is
    dropped from the cut-edge set — splitting an edge at t ~ 0 would
    produce sliver tets. The reference keys the endpoint choice off
    point-to-blade-line distance; the intersection parameter t encodes
    the same nearness (t < roi <=> the cut sits next to the from-node).
    Off by default, like the reference (m_flagDetectCutNodes = false,
    CuttableMesh.cpp:65). Returns (filtered cut_edge_t, snapped ids)."""
    snapped: set[int] = set()
    for ei, t in cut_edge_t.items():
        e = mesh.edges[ei]
        if t < roi:
            snapped.add(e.from_)
        elif t > 1.0 - roi:
            snapped.add(e.to)
    if not snapped:
        return dict(cut_edge_t), snapped
    kept = {
        ei: t for ei, t in cut_edge_t.items()
        if mesh.edges[ei].from_ not in snapped
        and mesh.edges[ei].to not in snapped
    }
    return kept, snapped


# ----------------------------------------------------------------- cuttable
@dataclass
class CutResult:
    n_cut_edges: int
    n_cut_cells: int
    n_new_cells: int
    n_cut_nodes: int = 0


class CuttableMesh:
    """VolMesh + cutting (reference CuttableMesh). Construction runs the
    invariant suite like the reference does (CuttableMesh.cpp:52)."""

    def __init__(self, nodes: np.ndarray, cells: np.ndarray):
        self.mesh = VolMesh(nodes, cells)
        errs = self.mesh.check_invariants()
        if errs:
            raise ValueError(f"invalid input mesh: {errs[:3]}")
        self.on_cut_completed = None

    def cut(self, sweep_quads: list[np.ndarray], modify: bool = True,
            snap_nodes: bool = False, snap_roi: float = 0.2) -> CutResult:
        """Classify and perform a cut along scalpel swept quads
        (reference CuttableMesh::cut, CuttableMesh.cpp:283-482).

        snap_nodes enables the cut-node snapping pre-pass
        (snap_cut_nodes; reference computeCutNodesKernel, off by default
        there too). Aborts (raises CutError) without mutating if any
        affected cell has an unsupported cut configuration — the
        reference's fail-safe.
        """
        mesh = self.mesh
        # 1. edge vs swept-quad intersections: ALL edges x ALL quads in
        # one jitted Moller-Trumbore batch (computeCutEdgesKernel /
        # Cutting.cl:59-102 analog; was a per-edge Python loop).
        live = [
            ei for ei in range(len(mesh.edges))
            if mesh.incident_cells_per_edge.get(ei)
        ]
        cut_edge_t: dict[int, float] = {}
        if live and sweep_quads:
            p0 = np.stack([mesh.nodes[mesh.edges[ei].from_].pos
                           for ei in live])
            p1 = np.stack([mesh.nodes[mesh.edges[ei].to].pos
                           for ei in live])
            quads = np.stack([np.asarray(q, np.float64)
                              for q in sweep_quads])
            hit, t = batched_edge_quad_hits(p0, p1, quads)
            cut_edge_t = {
                ei: float(t[i]) for i, ei in enumerate(live) if hit[i]
            }
        cut_nodes: set[int] = set()
        if snap_nodes and cut_edge_t:
            cut_edge_t, cut_nodes = snap_cut_nodes(
                mesh, cut_edge_t, roi=snap_roi
            )
        if not cut_edge_t:
            return CutResult(0, 0, 0, len(cut_nodes))

        # 2. per-cell cut classification; refuse unsupported before mutating.
        affected: dict[int, dict[int, float]] = {}
        for ci, cell in enumerate(mesh.cells):
            if cell is None:
                continue
            slots = {
                slot: cut_edge_t[e]
                for slot, e in enumerate(cell.edges)
                if e in cut_edge_t
            }
            if slots:
                comps = _corner_components(set(slots))
                if not _is_complete_cut(set(slots), comps):
                    raise CutError(
                        f"cell {ci}: unsupported cut configuration "
                        f"(slots {sorted(slots)})"
                    )
                affected[ci] = slots
        if not modify:
            return CutResult(len(cut_edge_t), len(affected), 0, len(cut_nodes))

        # 3. split each cut edge once, globally.
        splits: dict[int, tuple[int, int]] = {}
        for ei, t in cut_edge_t.items():
            e = mesh.edges[ei]
            length = np.linalg.norm(
                mesh.nodes[e.to].pos - mesh.nodes[e.from_].pos
            )
            splits[ei] = mesh.cut_edge(ei, t * length)

        # 4. subdivide affected cells.
        n_new = 0
        for ci, slots in affected.items():
            cell = mesh.cells[ci]
            cut_edges = {slot: splits[cell.edges[slot]] for slot in slots}
            n_new += len(subdivide_cell(mesh, ci, cut_edges))

        # 5. GC + invariants re-check (reference reruns TestVolMesh).
        mesh.garbage_collection()
        errs = mesh.check_invariants()
        if errs:
            raise CutError(f"post-cut invariant violations: {errs[:3]}")
        if self.on_cut_completed:
            self.on_cut_completed()
        return CutResult(len(cut_edge_t), len(affected), n_new, len(cut_nodes))
