"""Grid-structured FEM (fem.grid_fem): equality against the unstructured
corotational solver on the same Kuhn-tet mesh, multigrid preconditioner
properties, and transfer-operator adjointness.

The grid solver is the production path for the coupled frame (the
unstructured solver pays a gather and a scatter per matvec); these tests
pin its semantics to fem.integrator's,
which is itself pinned to the reference solver stack
(src/deformable/PS_VolumeConservingIntegrator.cpp).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fembrain.assets import MODELS_DIR
from fembrain.blob.reader import load_blob
from fembrain.fem import grid_fem as gfm
from fembrain.fem import integrator as integ
from fembrain.fem.integrator import FemState
from fembrain.fem.tetmesh import build_fem_mesh
from fembrain.mesh.polygonize import extract_tet_mesh, grid_for_scene

BLOB_DIR = str(MODELS_DIR / "blobtree")


@pytest.fixture(scope="module")
def sphere_setup():
    sc = load_blob(f"{BLOB_DIR}/sphere.blob")
    sc.flatten_instances()
    scene = sc.pack()
    grid = grid_for_scene(scene, cellsize=0.25)
    tm = extract_tet_mesh(
        scene, grid, ncap=grid.n_vertices, tetcap=grid.n_cells * 6
    )
    n_nodes = int(tm.n_nodes)
    nodes = np.asarray(tm.nodes)[:n_nodes]
    tets = np.asarray(tm.tets)[: int(tm.n_tets)]
    fixed = nodes[:, 1] < nodes[:, 1].min() + 1e-3
    mesh = build_fem_mesh(nodes, tets, fixed=fixed)
    gf = gfm.grid_fem_from_tetmesh(grid, tm, fixed_nodes=fixed)
    n2g = gfm.node_to_grid_index(tm)
    return scene, grid, tm, mesh, gf, n2g


def _to_grid(grid, n2g, arr_n):
    flat = np.zeros((int(np.prod(grid.dims)), 3), np.float32)
    flat[n2g] = np.asarray(arr_n, np.float32)
    return jnp.asarray(flat.reshape(*grid.dims, 3))


def _to_nodes(n2g, arr_g):
    return np.asarray(arr_g).reshape(-1, 3)[n2g]


def test_bool_fixed_mask_regression(sphere_setup):
    """build_fem_mesh used to cast bool masks to indices {0,1} — every
    profile that passed `nodes[:,1] < ymin+eps` anchored only 2 nodes."""
    _, _, _, mesh, gf, _ = sphere_setup
    n_fixed = int(np.asarray(mesh.fixed).sum())
    assert n_fixed > 2
    assert int(np.asarray(gf.active).sum() - np.asarray(gf.free).sum()) \
        == n_fixed


def test_mass_parity(sphere_setup):
    _, grid, _, mesh, gf, n2g = sphere_setup
    mg = np.asarray(gf.mass).reshape(-1)[n2g]
    mn = np.asarray(mesh.mass)
    np.testing.assert_allclose(mg, mn, rtol=1e-5)
    # no mass on inactive vertices
    total = float(np.asarray(gf.mass).sum())
    assert total == pytest.approx(float(mn.sum()), rel=1e-5)


def test_forces_and_matvec_parity(sphere_setup):
    _, grid, _, mesh, gf, n2g = sphere_setup
    rng = np.random.default_rng(0)
    qn = rng.normal(size=(mesh.n_nodes, 3)).astype(np.float32) * 0.01
    qn[np.asarray(mesh.fixed)] = 0.0
    qg = _to_grid(grid, n2g, qn)

    _, Rn = integ.co.element_kinematics(mesh, jnp.asarray(qn))
    fn = np.asarray(integ.co.internal_forces(mesh, jnp.asarray(qn), Rn))
    Rg = gfm.kinematics(gf, qg)
    fg = _to_nodes(n2g, gfm.internal_forces(gf, qg, Rg))
    scale = np.abs(fn).max()
    np.testing.assert_allclose(fg / scale, fn / scale, atol=2e-5)

    vn = rng.normal(size=(mesh.n_nodes, 3)).astype(np.float32)
    vg = _to_grid(grid, n2g, vn)
    krot = integ.co.rotated_stiffness(mesh, Rn)
    kn = np.asarray(integ.co.stiffness_apply_pre(mesh, krot, jnp.asarray(vn)))
    kg = _to_nodes(n2g, gfm.stiffness_apply_rot(gf, Rg, vg))
    scale = np.abs(kn).max()
    np.testing.assert_allclose(kg / scale, kn / scale, atol=2e-5)


def test_timestep_parity_both_preconditioners(sphere_setup):
    _, grid, _, mesh, gf, n2g = sphere_setup
    f_n = np.zeros((mesh.n_nodes, 3), np.float32)
    f_n[:, 1] = -100.0 * np.asarray(mesh.mass)
    f_g = _to_grid(grid, n2g, f_n)

    st_n, it_n = integ.timestep(mesh, FemState.rest(mesh), jnp.asarray(f_n))
    qs = np.abs(np.asarray(st_n.q)).max()
    assert qs > 0
    for prec in ("jacobi", "mg"):
        st_g, it_g = gfm.timestep(gf, gf.rest_state(), f_g, precond=prec)
        qg = _to_nodes(n2g, st_g.q)
        err = np.abs(qg - np.asarray(st_n.q)).max() / qs
        assert err < 1e-4, (prec, err)
        if prec == "mg":
            # multigrid must crush the iteration count
            assert int(it_g) < int(it_n) / 2, (int(it_g), int(it_n))
    # displacement never lands on inactive vertices
    inactive = ~np.asarray(gf.active)
    assert np.abs(np.asarray(st_g.q)[inactive]).max() == 0.0


def test_multistep_trajectory_parity(sphere_setup):
    _, grid, _, mesh, gf, n2g = sphere_setup
    f_n = np.zeros((mesh.n_nodes, 3), np.float32)
    f_n[:, 1] = -100.0 * np.asarray(mesh.mass)
    f_g = _to_grid(grid, n2g, f_n)

    stn, stg = FemState.rest(mesh), gf.rest_state()
    for _ in range(5):
        stn, _ = integ.timestep(mesh, stn, jnp.asarray(f_n))
        stg, it = gfm.timestep(gf, stg, f_g, precond="mg")
    qg = _to_nodes(n2g, stg.q)
    qs = np.abs(np.asarray(stn.q)).max()
    np.testing.assert_allclose(qg / qs, np.asarray(stn.q) / qs, atol=2e-4)


def test_transfer_adjointness(sphere_setup):
    """restriction must be the exact adjoint of prolongation (keeps the
    V-cycle symmetric, hence a valid CG preconditioner)."""
    _, _, _, _, gf, _ = sphere_setup
    assert len(gf.levels) >= 2
    rng = np.random.default_rng(3)
    fd, cd = gf.levels[0].dims, gf.levels[1].dims
    z = jnp.asarray(rng.normal(size=(3, *cd)).astype(np.float32))
    r = jnp.asarray(rng.normal(size=(3, *fd)).astype(np.float32))
    lhs = float(jnp.vdot(gfm.prolong(z, fd), r))
    rhs = float(jnp.vdot(z, gfm.restrict(r, cd)))
    assert lhs == pytest.approx(rhs, rel=1e-5)


def test_vcycle_symmetric_positive(sphere_setup):
    _, grid, _, _, gf, _ = sphere_setup
    rng = np.random.default_rng(4)
    free = np.asarray(gf.free)[..., None]
    mk = lambda s: jnp.asarray(  # noqa: E731
        np.where(free, rng.normal(size=(*grid.dims, 3)), 0.0).astype(
            np.float32
        )
    )
    r1, r2 = mk(1), mk(2)
    mc, sc = 1.0, 1.442e-3
    z1 = gfm.vcycle(gf.levels, mc, sc, r1)
    z2 = gfm.vcycle(gf.levels, mc, sc, r2)
    a = float(jnp.vdot(z1, r2))
    b = float(jnp.vdot(z2, r1))
    assert a == pytest.approx(b, rel=1e-3)
    assert float(jnp.vdot(z1, r1)) > 0
    assert float(jnp.vdot(z2, r2)) > 0


def test_differentiable_mode_gradient(sphere_setup):
    """E-scale gradient through the grid solve (custom_linear_solve)
    matches finite differences."""
    _, grid, _, _, gf, n2g = sphere_setup
    f_g = _to_grid(
        grid, n2g,
        np.tile([0.0, -50.0, 0.0], (len(n2g), 1)).astype(np.float32),
    )

    def loss(scale):
        gf2 = dataclasses.replace(gf, ke=gf.ke * scale)
        st, _ = gfm.timestep(
            gf2, gf.rest_state(), f_g, differentiable=True
        )
        return jnp.sum(st.q ** 2)

    g = jax.grad(loss)(jnp.float32(1.0))
    eps = 1e-2
    fd = (loss(jnp.float32(1 + eps)) - loss(jnp.float32(1 - eps))) / (2 * eps)
    assert float(g) == pytest.approx(float(fd), rel=5e-2)
