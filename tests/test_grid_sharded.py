"""Sharded grid FEM (fem.grid_sharded): X-slab SPMD solver must equal the
single-device grid solver; both preconditioners (replicated global MG,
communication-free Schwarz) must converge to the same solution."""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fembrain.assets import MODELS_DIR
from fembrain.blob.reader import load_blob
from fembrain.fem import grid_fem as gfm
from fembrain.fem import grid_sharded as gsh
from fembrain.mesh.polygonize import extract_tet_mesh, grid_for_scene

BLOB_DIR = str(MODELS_DIR / "blobtree")


@pytest.fixture(scope="module")
def setup():
    sc = load_blob(f"{BLOB_DIR}/sphere.blob")
    sc.flatten_instances()
    scene = sc.pack()
    grid = grid_for_scene(scene, cellsize=0.14)
    tm = extract_tet_mesh(
        scene, grid, ncap=grid.n_vertices, tetcap=grid.n_cells * 6
    )
    nodes = np.asarray(tm.nodes)[: int(tm.n_nodes)]
    fixed = np.where(nodes[:, 1] < nodes[:, 1].min() + 1e-3)[0]
    gf = gfm.grid_fem_from_tetmesh(grid, tm, fixed_nodes=fixed)
    n2g = gfm.node_to_grid_index(tm)
    f_ext = np.zeros((int(np.prod(grid.dims)), 3), np.float32)
    f_ext[n2g, 1] = -100.0 * np.asarray(gf.mass).reshape(-1)[n2g]
    f_ext = jnp.asarray(f_ext.reshape(*grid.dims, 3))
    return grid, tm, fixed, gf, f_ext


@pytest.mark.parametrize("n_parts", [2, 8])
def test_trajectory_matches_single_device(setup, n_parts):
    grid, tm, fixed, gf, f_ext = setup
    sgf = gsh.build_sharded_grid_fem(grid, tm, n_parts, fixed_nodes=fixed)
    mesh = gsh.make_grid_mesh(n_parts)
    q, v, dv = sgf.rest_state()
    fs = gsh.to_shard_layout(sgf, f_ext)
    step = jax.jit(
        lambda q, v, dv: gsh.sharded_timestep(sgf, mesh, q, v, fs, dv=dv)
    )
    st = gf.rest_state()
    for _ in range(3):
        st, it0 = gfm.timestep(gf, st, f_ext)
        q, v, dv, it = step(q, v, dv)
    qg = gsh.from_shard_layout(sgf, q)
    qs = float(jnp.abs(st.q).max())
    assert qs > 0
    assert float(jnp.abs(qg - st.q).max()) / qs < 1e-4
    # replicated-global-MG preconditioner: iteration count must track the
    # single-device solver (same V-cycle), not blow up with shards
    assert abs(int(it) - int(it0)) <= 5, (int(it), int(it0))


def test_schwarz_preconditioner_converges(setup):
    grid, tm, fixed, gf, f_ext = setup
    sgf = gsh.build_sharded_grid_fem(grid, tm, 4, fixed_nodes=fixed)
    mesh = gsh.make_grid_mesh(4)
    q, v, dv = sgf.rest_state()
    fs = gsh.to_shard_layout(sgf, f_ext)
    q, v, dv, it = jax.jit(
        lambda q, v, dv: gsh.sharded_timestep(
            sgf, mesh, q, v, fs, dv=dv, precond="schwarz"
        )
    )(q, v, dv)
    st, _ = gfm.timestep(gf, gf.rest_state(), f_ext)
    qg = gsh.from_shard_layout(sgf, q)
    qs = float(jnp.abs(st.q).max())
    assert float(jnp.abs(qg - st.q).max()) / qs < 1e-4


def test_layout_roundtrip(setup):
    grid, tm, fixed, _, f_ext = setup
    sgf = gsh.build_sharded_grid_fem(grid, tm, 8, fixed_nodes=fixed)
    back = gsh.from_shard_layout(sgf, gsh.to_shard_layout(sgf, f_ext))
    np.testing.assert_array_equal(np.asarray(back), np.asarray(f_ext))


def test_differentiable_gradient(setup):
    """E-gradient through the sharded solve (custom_linear_solve inside
    shard_map) matches finite differences."""
    import dataclasses

    grid, tm, fixed, gf, f_ext = setup
    sgf = gsh.build_sharded_grid_fem(grid, tm, 4, fixed_nodes=fixed)
    mesh = gsh.make_grid_mesh(4)
    q0, v0, dv0 = sgf.rest_state()
    fs = gsh.to_shard_layout(sgf, f_ext)

    def loss(scale):
        s2 = dataclasses.replace(
            sgf,
            local=dataclasses.replace(sgf.local, ke=sgf.local.ke * scale),
        )
        q, v, dv, _ = gsh.sharded_timestep(
            s2, mesh, q0, v0, fs, differentiable=True
        )
        return jnp.sum(q ** 2)

    g = float(jax.jit(jax.grad(loss))(jnp.float32(1.0)))
    lj = jax.jit(loss)
    eps = 1e-2
    fd = (float(lj(jnp.float32(1 + eps))) - float(lj(jnp.float32(1 - eps)))
          ) / (2 * eps)
    assert g == pytest.approx(fd, rel=5e-2)


def test_hybrid_preconditioner_matches_global_mg_iterations():
    """VERDICT r4 #5: the hybrid preconditioner (local fine smoothing +
    replicated-from-level-1) must match global_mg's iteration count to
    ~2 while gathering only the restricted residual; schwarz trades
    iterations for zero preconditioner traffic."""
    import numpy as np

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from fembrain.blob.reader import load_blob
    from fembrain.fem import grid_fem as gfm
    from fembrain.fem import grid_sharded as gsh
    from fembrain.mesh.polygonize import extract_tet_mesh, grid_for_scene
    from fembrain.mesh.samples import bottom_nodes_per_component

    sc = load_blob(str(MODELS_DIR / "blobtree" / "ventricle.blob"))
    sc.flatten_instances()
    scene = sc.pack()
    grid = grid_for_scene(scene, cellsize=0.35)
    tm = extract_tet_mesh(
        scene, grid, ncap=grid.n_vertices, tetcap=grid.n_cells * 6
    )
    nodes = np.asarray(tm.nodes)[: int(tm.n_nodes)]
    tets = np.asarray(tm.tets)[: int(tm.n_tets)]
    fixed = bottom_nodes_per_component(nodes, tets, frac=0.25)
    gf = gfm.grid_fem_from_tetmesh(grid, tm, fixed_nodes=fixed)
    n2g = gfm.node_to_grid_index(tm)
    f = np.zeros((int(np.prod(grid.dims)), 3), np.float32)
    f[n2g, 1] = -300.0 * np.asarray(gf.mass).reshape(-1)[n2g]
    f = jnp.asarray(f.reshape(*grid.dims, 3))
    ref, _ = gfm.timestep(gf, gf.rest_state(), f)

    sgf = gsh.build_sharded_grid_fem(grid, tm, 4, fixed_nodes=fixed)
    mesh = Mesh(np.array(jax.devices()[:4]), (gsh.GRID_AXIS,))
    fs = gsh.to_shard_layout(sgf, f)
    iters = {}
    for prec in ("global_mg", "hybrid", "schwarz"):
        q, v, dv = sgf.rest_state()
        q2, _, _, it = jax.jit(
            lambda q, v, dv, p=prec: gsh.sharded_timestep(
                sgf, mesh, q, v, fs, dv=dv, precond=p
            )
        )(q, v, dv)
        iters[prec] = int(it)
        err = float(jnp.abs(gsh.from_shard_layout(sgf, q2) - ref.q).max())
        assert err < 1e-5, (prec, err)
    assert iters["hybrid"] <= iters["global_mg"] + 2, iters
    assert iters["schwarz"] > iters["hybrid"], iters
