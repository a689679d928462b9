"""Headless simulation application — the analog of the reference's
`src/main.cpp` (GLUT loop + scene setup, :620-894): load a `.sim` config,
build the BlobTree scene, polygonize to surface + embedded tet mesh, set
up the FEM deformable, then step physics and couple displacements back to
the render surface every frame, optionally rendering PNG frames with the
sphere tracer.

CLI (CmdLineParser parity, src/main.cpp:633-639):
    python -m fembrain.app --file data/models/tumor.sim --frames 30
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

from .blob.reader import load_blob
from .fem.deformable import Deformable, couple_surface_displacements
from .fem.tetmesh import build_fem_mesh
from .mesh.polygonize import (
    check_capacity,
    default_caps,
    extract_tet_mesh,
    grid_for_scene,
    polygonize,
)
from .graphics.scenegraph import SceneGraph, SGMesh, SGNode
from .render.camera import Camera
from .render.sphere_trace import render_image
from .utils.config import SimConfig
from .utils.image import write_png
from .utils.logging import the_logger
from .utils.metrics import MetricsLogger, Record
from .utils.profiler import the_profiler


class SimulationApp:
    def __init__(self, sim_path: str | Path, cellsize: float | None = None,
                 metrics_path: str | Path | None = None):
        log = the_logger()
        prof = the_profiler()
        self.cfg = SimConfig.load(sim_path)
        blob_path = self.cfg.resolve_input(sim_path)
        log.info(f"loading blob {blob_path}")

        self.scene_def = load_blob(blob_path)
        self.scene_def.flatten_instances()
        self.scene = self.scene_def.pack()
        cs = cellsize or self.cfg.cellsize

        with prof.event("polygonize"):
            self.grid = grid_for_scene(self.scene, cs)
            vcap, tcap = default_caps(self.grid)
            self.surface = polygonize(self.scene, self.grid, vcap, tcap)
            check_capacity(self.surface)  # fail loudly, never corrupt
        with prof.event("tetrahedralize"):
            self.tetmesh = extract_tet_mesh(
                self.scene, self.grid,
                ncap=self.grid.n_vertices, tetcap=self.grid.n_cells * 6,
            )
            check_capacity(self.tetmesh)
        n_nodes = int(self.tetmesh.n_nodes)
        n_tets = int(self.tetmesh.n_tets)
        log.info(
            f"surface: {int(self.surface.n_verts)} verts "
            f"{int(self.surface.n_tris)} tris; tetmesh: {n_nodes} nodes "
            f"{n_tets} tets"
        )

        nodes = np.asarray(self.tetmesh.nodes)[:n_nodes]
        tets = np.asarray(self.tetmesh.tets)[:n_tets]
        fixed = [v for v in self.cfg.fixed_vertices if v < n_nodes]
        self.fem = build_fem_mesh(nodes, tets, fixed=fixed)
        self.deformable = Deformable(
            self.fem,
            ground_y=self.cfg.ground_level if self.cfg.gravity else None,
            gravity=-10000.0 if self.cfg.gravity else 0.0,
        )

        self.camera = Camera.orbit(
            self.cfg.cam_roll, 90.0 - self.cfg.cam_tilt, self.cfg.cam_zoom,
            target=self.cfg.cam_center,
        )
        self.frame = 0
        self.metrics = MetricsLogger(jsonl_path=metrics_path)
        self._grid_to_node = self.tetmesh.grid_to_node

        # Retained scene graph (reference TheSceneGraph, main.cpp:682-742):
        # the deformed tissue surface as a mesh node plus a physics driver
        # node whose timestep() advances the FEM; draw() yields world-space
        # geometry batches for the offline viewer.
        self.scenegraph = SceneGraph()
        self.scenegraph.camera = self.camera
        self._surface_node = SGMesh(
            "tissue",
            np.asarray(self.surface.verts)[: int(self.surface.n_verts)],
            np.asarray(self.surface.tris)[: int(self.surface.n_tris)],
        )
        self.scenegraph.add(self._surface_node)

        class _PhysicsNode(SGNode):
            def __init__(node, app):
                super().__init__("physics")
                node.app = app

            def timestep(node):
                node.app._last_disp = node.app.timestep()

        self._physics_node = self.scenegraph.add(_PhysicsNode(self))
        self._last_disp = None

    # ------------------------------------------------------------- stepping
    def timestep(self, haptic: tuple[np.ndarray, np.ndarray] | None = None):
        """One physics frame + surface coupling (reference timestep(),
        main.cpp:463 -> Deformable::timestep -> ApplyDeformations)."""
        prof = the_profiler()
        f = None
        if haptic is not None:
            idx, force = haptic
            f = self.deformable.haptic_forces(idx, force)
        t0 = time.perf_counter()
        with prof.event("fem_step"):
            state = self.deformable.timestep(f_haptic=f)
        with prof.event("apply_displacements"):
            disp = couple_surface_displacements(
                self.surface.edge_nodes,
                self.surface.edge_t,
                self._grid_to_node,
                state.q,
            )
        self.frame += 1
        # Keep the scene-graph surface node in world-space sync
        # (ApplyVertexDeformations analog for the retained draw path).
        nv = int(self.surface.n_verts)
        self._surface_node.verts = np.asarray(
            self.surface.verts + disp
        )[:nv]
        dt = time.perf_counter() - t0
        st = self.deformable.stats()
        self.metrics.append(
            Record(
                model_name=self.scene_def.name,
                ct_elements=self.fem.n_tets,
                ct_vertices=self.fem.n_nodes,
                ms_anim_total_frame=dt * 1e3,
                cg_iters=st.get("cg_iters", 0),
                fps=1.0 / max(dt, 1e-9),
            )
        )
        return disp

    def deformed_vertices(self, disp) -> jax.Array:
        """rest surface + FEM displacement (ApplyVertexDeformations parity,
        data/opencl/Polygonizer.cl:1417-1426)."""
        return self.surface.verts + disp

    def refit_rbf(self, max_points: int = 400, offset: float = 0.1):
        """Fit a FastRBF to the CURRENT deformed surface so collision /
        haptic queries see the deformed tissue, not the rest-pose
        analytic field (reference RBF.h:51-136, trained from
        ComputeOffSurfacePointsAndFields, OclPolygonizer.cpp /
        Polygonizer.cl:1329-1350). Normals come from the deformed field's
        autodiff gradient (render.deformed), so off-surface samples sit
        on the true displaced offset surfaces. Returns (and stores) the
        fitted FastRBF."""
        from .ops.rbf import FastRBF, off_surface_samples
        from .render.deformed import deformed_field, displacement_grid

        q = self.deformable.state.q
        disp = couple_surface_displacements(
            self.surface.edge_nodes, self.surface.edge_t,
            self._grid_to_node, q,
        )
        nv = int(self.surface.n_verts)
        verts = np.asarray(self.surface.verts + disp)[:nv]
        stride = max(1, nv // max_points)
        verts = verts[::stride]

        u_grid = displacement_grid(self.grid, self._grid_to_node, q)

        def fp(p):
            return deformed_field(self.scene, self.grid, u_grid, p[None])[0]

        g = np.asarray(jax.vmap(jax.grad(fp))(jnp.asarray(verts)))
        n = -g / np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-12)

        pts, vals = off_surface_samples(verts, n, offset=offset)
        rbf = FastRBF()
        rbf.fit_greedy(pts, vals)
        self.rbf = rbf
        return rbf

    def render_frame(self, width=400, height=300, hud=False):
        """Render the CURRENT (deformed) tissue: the sphere tracer sees
        the FEM displacement field, not just the rest-pose analytic scene
        (reference couples every frame via ApplyVertexDeformations,
        OclPolygonizer.cpp:1543-1596 — here the coupling is in field
        space, render.deformed). hud=True overlays the live per-frame
        stats rows (the reference's SGHeaders HUD, src/main.cpp:877-887:
        animation/mesh/solver lines refreshed every frame)."""
        q = self.deformable.state.q
        if float(jnp.max(jnp.abs(q))) > 1e-9:
            from .render.deformed import render_deformed

            img = render_deformed(
                self.scene, self.grid, self._grid_to_node, q,
                self.camera, width, height,
            )
        else:
            img = render_image(self.scene, self.camera, width, height)
        img = np.clip(np.asarray(img), 0, 1)
        if hud:
            img = self._hud_overlay(img)
        return img

    def _hud_overlay(self, img):
        """Stamp the SGHeaders-analog rows from the latest metrics
        record into the frame."""
        from .render.viewer import _put_text

        rec = self.metrics.last
        lines = [
            f"{self.scene_def.name}  "
            f"tets={self.fem.n_tets} nodes={self.fem.n_nodes} "
            f"prims={self.scene.n_prims}",
        ]
        if rec is not None:
            lines.append(
                f"frame {self.frame}  {rec.fps:6.1f} fps  "
                f"fem {rec.ms_anim_total_frame:6.2f} ms  "
                f"cg {rec.cg_iters}"
            )
        q = np.asarray(self.deformable.state.q)
        lines.append(f"max|q| {np.abs(q).max():.4f}")
        return _put_text(img, chr(10).join(lines))

    def close(self):
        self.metrics.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="FemBrain headless app")
    ap.add_argument("--file", required=True, help=".sim config path")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--cellsize", type=float, default=None)
    ap.add_argument("--render-every", type=int, default=0,
                    help="write a PNG every N frames (0 = never)")
    ap.add_argument("--out", default="frames",
                    help="directory for rendered PNG frames")
    ap.add_argument("--metrics", default=None, help="JSONL metrics path")
    ap.add_argument("--hud", action="store_true",
                    help="overlay live per-frame stats on rendered "
                         "frames (SGHeaders analog)")
    ap.add_argument("--xprof", default=None, help="jax.profiler trace dir")
    ap.add_argument("--debug-nans", action="store_true",
                    help="fail fast on NaN in any jitted computation "
                         "(the purity-era analog of the reference's "
                         "by-construction race safety, SURVEY 5.2)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save FEM state every N frames (0 = never)")
    ap.add_argument("--checkpoint", default="fembrain_ckpt.npz",
                    help="checkpoint path for --checkpoint-every/--resume")
    ap.add_argument("--resume", action="store_true",
                    help="restore FEM state from --checkpoint before "
                         "stepping (checkpoint-restart around the sim "
                         "loop, SURVEY 5.3/5.4)")
    args = ap.parse_args(argv)

    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)

    from .utils.checkpoint import (
        enable_compilation_cache,
        load_pytree,
        save_pytree,
    )

    enable_compilation_cache()
    app = SimulationApp(args.file, cellsize=args.cellsize,
                        metrics_path=args.metrics)

    if args.resume:
        app.deformable.state = load_pytree(
            args.checkpoint, app.deformable.state
        )
        the_logger().info(f"resumed FEM state from {args.checkpoint}")
    outdir = Path(args.out)
    if args.render_every:
        outdir.mkdir(parents=True, exist_ok=True)

    ctx = None
    if args.xprof:
        from .utils.profiler import xprof_trace

        ctx = xprof_trace(args.xprof)
        ctx.__enter__()

    disp = None
    for i in range(args.frames):
        disp = app.timestep()
        if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            # Full state including dv (the CG warm start), so a resumed
            # run continues with identical solver behavior.
            save_pytree(args.checkpoint, app.deformable.state)
        if args.render_every and i % args.render_every == 0:
            img = app.render_frame(hud=args.hud)
            write_png(outdir / f"frame_{i:04d}.png", img)

    if ctx is not None:
        ctx.__exit__(None, None, None)

    q = np.asarray(app.deformable.state.q)
    print(
        f"done: {args.frames} frames, max|q|={np.abs(q).max():.5f}, "
        f"stats={the_profiler().stats()}"
    )
    app.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
