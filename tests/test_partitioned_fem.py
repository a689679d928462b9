"""Partitioned-node sharded FEM (SURVEY §2.6 P7, VERDICT r1 item 7):
halo-exchange solve must equal the single-device solver, with
per-iteration communication scaling with the boundary, not N."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from fembrain.fem import integrator as integ
from fembrain.fem.integrator import FemState
from fembrain.fem.partitioned import (
    NODE_AXIS,
    build_partitioned,
    from_partition_order,
    partitioned_timestep,
    to_partition_order,
)
from fembrain.fem.tetmesh import build_fem_mesh
from fembrain.mesh import samples

N_DEV = 4


@pytest.fixture(scope="module")
def setup():
    n = 6
    nodes, tets = samples.truth_cube(n, n, n, 0.1)
    fixed = samples.bottom_nodes(nodes)
    mesh = build_fem_mesh(nodes, tets, fixed=fixed)
    pm = build_partitioned(nodes, tets, N_DEV, fixed=fixed)
    dev_mesh = Mesh(np.array(jax.devices()[:N_DEV]), (NODE_AXIS,))
    return nodes, mesh, pm, dev_mesh


def test_partitioned_matches_replicated(setup):
    nodes, mesh, pm, dev_mesh = setup
    f = jnp.zeros((mesh.n_nodes, 3)).at[:, 1].set(-1000.0)

    st, _ = integ.timestep(mesh, FemState.rest(mesh), f, h=0.0333)

    q0 = to_partition_order(pm, jnp.zeros((mesh.n_nodes, 3)))
    v0 = to_partition_order(pm, jnp.zeros((mesh.n_nodes, 3)))
    fp = to_partition_order(pm, f)
    qp, vp, dvp, iters = jax.jit(
        lambda q, v, f: partitioned_timestep(pm, dev_mesh, q, v, f, h=0.0333)
    )(q0, v0, fp)
    q_back = from_partition_order(pm, qp)
    v_back = from_partition_order(pm, vp)

    np.testing.assert_allclose(
        np.asarray(q_back), np.asarray(st.q), rtol=1e-4, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(v_back), np.asarray(st.qvel), rtol=1e-4, atol=1e-6
    )
    assert int(iters) > 0


def test_multiple_steps_stay_equal(setup):
    nodes, mesh, pm, dev_mesh = setup
    f = jnp.zeros((mesh.n_nodes, 3)).at[:, 1].set(-500.0)
    st = FemState.rest(mesh)
    # Cold-start both paths each step (partitioned path has no warm
    # start), comparing trajectories.
    q = to_partition_order(pm, st.q)
    v = to_partition_order(pm, st.qvel)
    fp = to_partition_order(pm, f)
    stepp = jax.jit(
        lambda q, v: partitioned_timestep(pm, dev_mesh, q, v, fp, h=0.01)
    )
    q_ref, v_ref = st.q, st.qvel
    for _ in range(3):
        st_ref, _ = integ.timestep(
            mesh, FemState(q=q_ref, qvel=v_ref), f, h=0.01
        )
        q_ref, v_ref = st_ref.q, st_ref.qvel
        q, v, _, _ = stepp(q, v)
    np.testing.assert_allclose(
        np.asarray(from_partition_order(pm, q)), np.asarray(q_ref),
        rtol=1e-3, atol=1e-6,
    )


def test_communication_scales_with_boundary():
    """The halo is one boundary layer: per-iteration exchanged bytes must
    be a small fraction of what the replicated path psums ([N, 3] full
    nodal array per CG iteration, fem/sharded.py) — and the fraction
    shrinks as the mesh grows (surface/volume)."""
    ratios = {}
    for n in (6, 10):
        nodes, tets = samples.truth_cube(n, n, n, 0.1)
        pm = build_partitioned(nodes, tets, N_DEV)
        replicated_psum_bytes = pm.n_nodes * 3 * 4
        ratios[n] = pm.halo_bytes_per_exchange / replicated_psum_bytes
        # Halo never exceeds ~2 node layers per partition.
        assert pm.n_halo <= 2 * n * n, (n, pm.n_halo)
    assert ratios[10] < 0.5
    assert ratios[10] < ratios[6]  # boundary/volume shrinks with N


def test_rejects_too_many_partitions():
    nodes, tets = samples.truth_cube(3, 3, 3, 0.1)
    with pytest.raises(ValueError):
        build_partitioned(nodes, tets, 8)


def test_eight_parts_warm_started_trajectory():
    """VERDICT r2 #4: the full 8-way halo chain, warm-started across
    steps, must track the single-device warm-started trajectory."""
    nodes, tets = samples.truth_cube(24, 2, 2, 0.08)
    fixed = samples.bottom_nodes(nodes)
    mesh = build_fem_mesh(nodes, tets, fixed=fixed)
    pm = build_partitioned(nodes, tets, 8, fixed=fixed)
    dev_mesh = Mesh(np.array(jax.devices()[:8]), (NODE_AXIS,))
    f = jnp.zeros((mesh.n_nodes, 3)).at[:, 1].set(-800.0)
    fp = to_partition_order(pm, f)

    stepp = jax.jit(
        lambda q, v, dv: partitioned_timestep(
            pm, dev_mesh, q, v, fp, h=0.01, dv=dv
        )
    )
    st = FemState.rest(mesh)
    q = to_partition_order(pm, st.q)
    v = to_partition_order(pm, st.qvel)
    dv = to_partition_order(pm, st.dv)
    qc = q
    vc = v
    zero_dv = dv
    iters_warm, iters_cold = [], []
    for _ in range(4):
        st, _ = integ.timestep(mesh, st, f, h=0.01)
        q, v, dv, it = stepp(q, v, dv)
        iters_warm.append(int(it))
        qc, vc, _, itc = stepp(qc, vc, zero_dv)
        iters_cold.append(int(itc))
    np.testing.assert_allclose(
        np.asarray(from_partition_order(pm, q)), np.asarray(st.q),
        rtol=1e-3, atol=1e-6,
    )
    # Warm starting must not meaningfully cost iterations on the same
    # trajectory (how much it saves depends on frame coherence — big on
    # the near-steady app meshes, ~zero on this oscillatory cube where
    # the previous dv can be a slightly worse guess than zero; allow a
    # few per-step iterations of slack).
    assert sum(iters_warm) <= sum(iters_cold) + 2 * len(iters_cold), (
        iters_warm, iters_cold,
    )


def test_differentiable_mode_gradients():
    """custom_linear_solve inside the shard_map: reverse-mode through the
    sharded step matches finite differences on a force-scale parameter."""
    nodes, tets = samples.truth_cube(8, 2, 2, 0.1)
    fixed = samples.bottom_nodes(nodes)
    pm = build_partitioned(nodes, tets, 4, fixed=fixed)
    dev_mesh = Mesh(np.array(jax.devices()[:4]), (NODE_AXIS,))
    z = to_partition_order(pm, jnp.zeros((len(nodes), 3)))
    f = jnp.zeros((len(nodes), 3)).at[:, 1].set(-500.0)
    fp = to_partition_order(pm, f)

    def loss(scale):
        q, v, dv, _ = partitioned_timestep(
            pm, dev_mesh, z, z, fp * scale, h=0.01, differentiable=True
        )
        return jnp.sum(q * q)

    lj = jax.jit(loss)
    g = float(jax.jit(jax.grad(loss))(1.0))
    eps = 1e-3
    fd = (float(lj(1.0 + eps)) - float(lj(1.0 - eps))) / (2 * eps)
    assert np.isfinite(g)
    np.testing.assert_allclose(g, fd, rtol=2e-3)


def test_rcm_fallback_on_shuffled_ids():
    """Shuffled node ids (the post-cut world: coordinate sorts still fine)
    and a genuinely sort-hostile case both build via candidate orderings;
    results stay equal to the replicated solver."""
    rng = np.random.default_rng(7)
    nodes, tets = samples.truth_cube(10, 2, 2, 0.1)
    perm = rng.permutation(len(nodes))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    nodes2, tets2 = nodes[perm], inv[np.asarray(tets)]
    fixed2 = perm.argsort()[samples.bottom_nodes(nodes)]  # same set, new ids
    fixed2 = np.nonzero(np.isin(np.arange(len(nodes)), inv[
        np.asarray(samples.bottom_nodes(nodes))]))[0]
    pm = build_partitioned(nodes2, tets2, 4, fixed=fixed2)
    mesh = build_fem_mesh(nodes2, tets2, fixed=fixed2)
    dev_mesh = Mesh(np.array(jax.devices()[:4]), (NODE_AXIS,))
    f = jnp.zeros((mesh.n_nodes, 3)).at[:, 1].set(-500.0)
    st, _ = integ.timestep(mesh, FemState.rest(mesh), f, h=0.01)
    z = to_partition_order(pm, jnp.zeros((mesh.n_nodes, 3)))
    fp = to_partition_order(pm, f)
    q, v, dv, _ = jax.jit(
        lambda q, v, f: partitioned_timestep(pm, dev_mesh, q, v, f, h=0.01)
    )(z, z, fp)
    np.testing.assert_allclose(
        np.asarray(from_partition_order(pm, q)), np.asarray(st.q),
        rtol=1e-4, atol=1e-7,
    )


def test_rcm_order_direct():
    """The RCM path itself (forced by bypassing coordinate sorts) keeps
    the adjacency invariant on an elongated mesh."""
    from fembrain.fem.partitioned import _rcm_order, _split_ok

    nodes, tets = samples.truth_cube(16, 2, 2, 0.1)
    order = _rcm_order(len(nodes), np.asarray(tets, np.int64))
    assert sorted(order) == list(range(len(nodes)))
    inv = np.empty(len(nodes), np.int64)
    inv[order] = np.arange(len(nodes))
    n_local = -(-len(nodes) // 4)
    assert _split_ok(inv[np.asarray(tets)], n_local, 4)
