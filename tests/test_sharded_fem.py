"""Sharded FEM step == single-device step, on the 8-device CPU mesh."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fembrain.fem import integrator as integ
from fembrain.fem import sharded
from fembrain.fem.integrator import FemState
from fembrain.fem.tetmesh import build_fem_mesh
from fembrain.mesh import samples


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_step_matches_single_device():
    nodes, tets = samples.truth_cube(4, 4, 4, 0.4)
    fixed = samples.bottom_nodes(nodes)
    mesh = build_fem_mesh(nodes, tets, fixed=fixed, E=1e6)
    f = np.zeros((len(nodes), 3))
    f[:, 1] = -500.0
    f = jnp.asarray(f, jnp.float32)

    state = FemState.rest(mesh)
    ref, it_ref = integ.timestep(mesh, state, f, h=0.02)

    dm = sharded.make_tet_mesh_axis(8)
    mesh_p = sharded.pad_mesh_for_sharding(mesh, 8)
    mesh_p = sharded.place_sharded(mesh_p, dm)
    out, it = sharded.sharded_timestep(mesh_p, dm, state, f, h=0.02)

    np.testing.assert_allclose(
        np.asarray(out.q), np.asarray(ref.q), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(out.qvel), np.asarray(ref.qvel), rtol=1e-4, atol=1e-6
    )


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_sharded_multi_step_stable():
    nodes, tets = samples.truth_cube(3, 3, 3, 0.5)
    mesh = build_fem_mesh(nodes, tets, fixed=samples.bottom_nodes(nodes))
    dm = sharded.make_tet_mesh_axis(4)
    mesh_p = sharded.place_sharded(
        sharded.pad_mesh_for_sharding(mesh, 4), dm
    )
    f = jnp.zeros((len(nodes), 3)).at[:, 1].set(-200.0)
    st = FemState.rest(mesh)
    step = jax.jit(
        lambda s: sharded.sharded_timestep(mesh_p, dm, s, f, h=0.0333)[0]
    )
    for _ in range(10):
        st = step(st)
    assert np.isfinite(np.asarray(st.q)).all()
    assert np.abs(np.asarray(st.q)).max() > 0
