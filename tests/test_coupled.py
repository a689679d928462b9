"""Coupled differentiable render+deform (BASELINE config #5).

One jitted graph: force -> implicit FEM solve -> displacement field ->
deformed sphere trace -> scalar loss, with gradients reaching the
material (Young's modulus scale) and the BlobTree primitive parameters.
Reference coupling being matched: OclPolygonizer.cpp:1543-1596 +
ApplyVertexDeformations (data/opencl/Polygonizer.cl:1417-1426).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fembrain.assets import blob_path
from fembrain.blob.reader import load_blob
from fembrain.fem.integrator import FemState
from fembrain.fem.tetmesh import build_fem_mesh
from fembrain.mesh.polygonize import extract_tet_mesh, grid_for_scene
from fembrain.render.camera import Camera, generate_rays
from fembrain.render.deformed import (
    coupled_step,
    displacement_grid,
    render_deformed,
    trace_deformed,
)
from fembrain.render.sphere_trace import TraceParams, trace

SPHERE = blob_path("sphere")


@pytest.fixture(scope="module")
def setup():
    scene = load_blob(SPHERE).pack()
    grid = grid_for_scene(scene, cellsize=0.35)
    tm = extract_tet_mesh(
        scene, grid, ncap=grid.n_vertices, tetcap=grid.n_cells * 6
    )
    n_nodes, n_tets = int(tm.n_nodes), int(tm.n_tets)
    nodes = np.asarray(tm.nodes)[:n_nodes]
    tets = np.asarray(tm.tets)[:n_tets]
    fixed = np.nonzero(nodes[:, 1] < nodes[:, 1].min() + 1e-6)[0]
    fem = build_fem_mesh(nodes, tets, fixed=fixed)
    cam = Camera.orbit(20.0, 15.0, 2.5)
    ro, rd = generate_rays(cam, 24, 18)
    return scene, grid, tm.grid_to_node, fem, ro.reshape(-1, 3), rd.reshape(-1, 3)


def test_zero_displacement_matches_rest_trace(setup):
    scene, grid, g2n, fem, ro, rd = setup
    u = jnp.zeros((fem.n_nodes, 3))
    u_grid = displacement_grid(grid, g2n, u)
    t0, h0 = trace(scene, ro, rd)
    t1, h1 = trace_deformed(scene, grid, u_grid, ro, rd)
    h0, h1 = np.asarray(h0), np.asarray(h1)
    # Brackets differ (slab vs per-prim interval) but hits must agree.
    assert (h0 == h1).mean() > 0.99
    m = h0 & h1
    assert np.abs(np.asarray(t0)[m] - np.asarray(t1)[m]).max() < 5e-3


def test_constant_displacement_translates_surface(setup):
    scene, grid, g2n, fem, ro, rd = setup
    # Displace every tet node by c: within the mesh, F(y) = f(y - c).
    c = jnp.asarray([0.0, -0.12, 0.0])
    u = jnp.broadcast_to(c, (fem.n_nodes, 3))
    u_grid = displacement_grid(grid, g2n, u)
    t1, h1 = trace_deformed(scene, grid, u_grid, ro, rd)
    sc2 = dataclasses.replace(scene, prim_pos=scene.prim_pos + c)
    t2, h2 = trace(sc2, ro, rd)
    h1, h2 = np.asarray(h1), np.asarray(h2)
    both = h1 & h2
    assert both.sum() > 10
    # Where both hit, roots agree to march accuracy. (Near the mesh
    # boundary the displacement field decays to zero over one voxel, so
    # only compare interior hits: rays whose hit normal faces the camera.)
    diff = np.abs(np.asarray(t1)[both] - np.asarray(t2)[both])
    assert np.median(diff) < 2e-2


def test_sagging_visible_under_gravity(setup):
    """Gravity pulls the free nodes down: the deformed render must differ
    from the rest render and the mean hit point must move down."""
    scene, grid, g2n, fem, ro, rd = setup
    f = jnp.zeros((fem.n_nodes, 3)).at[:, 1].set(-8000.0 * fem.mass)
    st = FemState.rest(fem)
    t, hit, st2 = jax.jit(
        lambda s: coupled_step(scene, fem, grid, g2n, s, f, ro, rd)
    )(st)
    assert float(jnp.max(jnp.abs(st2.q))) > 1e-4
    t0, hit0 = trace(scene, ro, rd)
    y_def = np.asarray(ro + t[:, None] * rd)[np.asarray(hit), 1]
    y_rest = np.asarray(ro + t0[:, None] * rd)[np.asarray(hit0), 1]
    assert y_def.mean() < y_rest.mean()


def test_north_star_gradients(setup):
    """Image loss -> FEM -> E gradient matches finite differences, and
    gradients also reach primitive positions (VERDICT round-1 item 2)."""
    scene, grid, g2n, fem, ro, rd = setup
    f = jnp.zeros((fem.n_nodes, 3)).at[:, 1].set(-8000.0 * fem.mass)
    st = FemState.rest(fem)

    # Fix the hit set at the base parameters: the raw hit mask flips
    # discretely under parameter perturbations (rays entering/leaving the
    # silhouette), which is not the derivative being checked.
    t_b, hit_b, _ = jax.jit(
        lambda: coupled_step(scene, fem, grid, g2n, st, f, ro, rd)
    )()
    hit0 = jax.lax.stop_gradient(hit_b)

    def loss(E_scale, prim_pos):
        sc = dataclasses.replace(scene, prim_pos=prim_pos)
        t, hit, _ = coupled_step(
            sc, fem, grid, g2n, st, f, ro, rd, E_scale=E_scale
        )
        return jnp.sum(jnp.where(hit0, t, 0.0))

    lj = jax.jit(loss)
    gE, gP = jax.jit(jax.grad(loss, argnums=(0, 1)))(1.0, scene.prim_pos)
    gE = float(gE)
    assert np.isfinite(gE) and abs(gE) > 0.0

    eps = 0.01
    fd_E = (float(lj(1.0 + eps, scene.prim_pos))
            - float(lj(1.0 - eps, scene.prim_pos))) / (2 * eps)
    assert abs(gE - fd_E) / max(abs(fd_E), 1e-6) < 0.05, (gE, fd_E)

    # Primitive-position gradient (y component) vs finite differences.
    base = np.asarray(scene.prim_pos)
    eps_p = 1e-3
    dp, dm = base.copy(), base.copy()
    dp[0, 1] += eps_p
    dm[0, 1] -= eps_p
    fd_p = (float(lj(1.0, jnp.asarray(dp)))
            - float(lj(1.0, jnp.asarray(dm)))) / (2 * eps_p)
    gp = float(np.asarray(gP)[0, 1])
    assert abs(gp - fd_p) / max(abs(fd_p), 1e-6) < 0.05, (gp, fd_p)


def test_render_deformed_image(setup):
    scene, grid, g2n, fem, ro, rd = setup
    u = jnp.zeros((fem.n_nodes, 3)).at[:, 1].add(-0.08)
    img = np.asarray(
        render_deformed(scene, grid, g2n, u, Camera.orbit(20, 15, 2.5),
                        32, 24)
    )
    assert img.shape == (24, 32, 3) and np.isfinite(img).all()
    assert (img < 0.99).any()
