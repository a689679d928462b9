#!/usr/bin/env python
"""Coupled E-gradient check in float64 on the CPU (bench.py runs it in a
subprocess that stays off the GPU; x64 is a process-global JAX flag, so
it cannot run inside the bench process).

Why f64: the check compares d(loss)/dE_scale with loss = sum over hit
rays of t. The derivative is small against the loss, so a central FD
probes an increment near the f32 trace's arithmetic noise (march step
patterns shift between the E+eps and E-eps runs, so the noise does not
cancel); in f64 the FD is valid as long as the hit set is stable across
the stencil, which the check asserts. Gradient correctness is a property
of the traced graph, not of the accelerator, so checking it in f64 on the
CPU validates the same program the GPU runs.

Prints ONE JSON line:
  {"rel_err": ..., "autodiff": ..., "fd": ..., "hit_flips": 0, "eps": ...}
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402


def main() -> None:
    import dataclasses

    from fembrain.assets import load_scene
    from fembrain.fem import grid_fem as gfm
    from fembrain.mesh.polygonize import extract_tet_mesh, grid_for_scene
    from fembrain.mesh.samples import bottom_nodes_per_component
    from fembrain.render.camera import Camera, generate_rays
    from fembrain.render.deformed import (
        build_disp_interp,
        coupled_step_grid_fast,
    )

    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="sphere",
                    help="a scene in data/models/blobtree (sphere, tumor, "
                         "brain)")
    ap.add_argument("--cellsize", type=float, default=None)
    args = ap.parse_args()
    cellsize = args.cellsize or (0.3 if args.scene == "sphere" else 0.35)

    scene = load_scene(args.scene)
    grid = grid_for_scene(scene, cellsize=cellsize)
    tm = extract_tet_mesh(
        scene, grid, ncap=grid.n_vertices, tetcap=grid.n_cells * 6
    )
    nodes = np.asarray(tm.nodes)[: int(tm.n_nodes)]
    tets = np.asarray(tm.tets)[: int(tm.n_tets)]
    fixed = bottom_nodes_per_component(nodes, tets, frac=0.25)
    gf = gfm.grid_fem_from_tetmesh(grid, tm, fixed_nodes=fixed)
    interp = build_disp_interp(nodes, n_centers=64, fixed=fixed)
    n2g = gfm.node_to_grid_index(tm)
    cgi = jnp.asarray(n2g[np.asarray(interp.center_nodes)])
    f_ext = np.zeros((int(np.prod(grid.dims)), 3))
    f_ext[n2g, 1] = -200.0 * np.asarray(gf.mass).reshape(-1)[n2g]
    f_ext = jnp.asarray(f_ext.reshape(*grid.dims, 3))

    zoom = 5.0 if args.scene == "sphere" else 8.0
    cam = Camera.orbit(30.0, 20.0, zoom)
    ro, rd = generate_rays(cam, 24, 18)
    ro = ro.reshape(-1, 3).astype(jnp.float64)
    rd = rd.reshape(-1, 3).astype(jnp.float64)

    def step_t(es):
        t, hit, _ = coupled_step_grid_fast(
            scene, gf, interp, cgi, gf.rest_state(), f_ext, ro, rd,
            E_scale=es, differentiable=True, use_pallas=False,
        )
        return t, hit

    @jax.jit
    def loss(es):
        t, hit = step_t(es)
        return jnp.sum(jnp.where(hit, t, 0.0))

    @jax.jit
    def hits(es):
        return step_t(es)[1]

    eps = 1e-2
    g = float(jax.jit(jax.grad(loss))(jnp.float64(1.0)))
    fd = (float(loss(jnp.float64(1 + eps)))
          - float(loss(jnp.float64(1 - eps)))) / (2 * eps)
    # Smoothness precondition: the hit set must not change across the FD
    # stencil (a flip adds an O(t_exit) jump FD sees but autodiff, which
    # differentiates the fixed-topology branch, legitimately cannot).
    h0 = np.asarray(hits(jnp.float64(1.0)))
    hp = np.asarray(hits(jnp.float64(1 + eps)))
    hm = np.asarray(hits(jnp.float64(1 - eps)))
    flips = int(np.sum(h0 != hp) + np.sum(h0 != hm))
    rel = abs(g - fd) / max(1e-12, abs(fd))
    print(json.dumps({
        "scene": args.scene,
        "rel_err": round(rel, 6),
        "autodiff": g,
        "fd": fd,
        "hit_flips": flips,
        "eps": eps,
        "n_hit": int(h0.sum()),
    }))


if __name__ == "__main__":
    main()
