"""FEM tests: element stiffness analytics, corotational invariances,
implicit integration behavior, ground collision, haptic rings, coupling
(reference test strategy per SURVEY §4: single-tet analytic checks,
TruthCube fixtures, energy behavior)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fembrain.fem import corotational as co
from fembrain.fem import integrator as integ
from fembrain.fem.deformable import (
    Deformable,
    couple_surface_displacements,
    haptic_ring_forces,
    node_adjacency,
)
from fembrain.fem.integrator import FemState
from fembrain.fem.tetmesh import build_fem_mesh
from fembrain.mesh import samples


def _mesh(nodes, tets, fixed=None, **kw):
    return build_fem_mesh(nodes, tets, fixed=fixed, **kw)


def test_element_stiffness_properties():
    nodes, tets = samples.one_tetra()
    m = _mesh(nodes, tets)
    ke = np.asarray(m.ke)[0]
    # Symmetric.
    np.testing.assert_allclose(ke, ke.T, atol=1e-2)
    # Rigid translations produce zero force: Ke @ (t,t,t,t) = 0.
    for a in range(3):
        t = np.zeros(12)
        t[a::3] = 1.0
        np.testing.assert_allclose(ke @ t, 0.0, atol=np.abs(ke).max() * 1e-6)
    # PSD (eigenvalues >= 0, 6 rigid modes ~ 0).
    w = np.linalg.eigvalsh(ke)
    assert w[0] > -np.abs(w[-1]) * 1e-6
    assert (np.abs(w[:6]) < np.abs(w[-1]) * 1e-5).sum() >= 6


def test_polar_rotation():
    rng = np.random.default_rng(0)
    # Random rotations times symmetric stretch.
    def rand_rot(n):
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        x, y, z, w = q.T
        return np.stack([
            np.stack([1-2*(y*y+z*z), 2*(x*y-w*z), 2*(x*z+w*y)], -1),
            np.stack([2*(x*y+w*z), 1-2*(x*x+z*z), 2*(y*z-w*x)], -1),
            np.stack([2*(x*z-w*y), 2*(y*z+w*x), 1-2*(x*x+y*y)], -1),
        ], -2)

    R0 = rand_rot(32)
    S = rng.uniform(0.5, 2.0, size=(32, 3))
    F = np.einsum("tij,tj,tkj->tik", R0, S, np.eye(3)[None].repeat(32, 0))
    F = np.einsum("tij,tjk->tik", R0, S[:, :, None] * np.eye(3))
    R = np.asarray(co.polar_rotation(jnp.asarray(F, jnp.float32)))
    np.testing.assert_allclose(R, R0, atol=2e-4)


def test_zero_displacement_zero_force():
    nodes, tets = samples.truth_cube(3, 3, 3, 0.5)
    m = _mesh(nodes, tets)
    u = jnp.zeros_like(m.rest)
    _, R = co.element_kinematics(m, u)
    f = np.asarray(co.internal_forces(m, u, R))
    np.testing.assert_allclose(f, 0.0, atol=1e-2)


def test_rigid_rotation_zero_force():
    """Corotational formulation: pure rigid motion produces ~no force."""
    nodes, tets = samples.truth_cube(3, 3, 3, 0.5)
    m = _mesh(nodes, tets)
    th = 0.7
    Rz = np.array(
        [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]]
    )
    x = np.asarray(m.rest) @ Rz.T + np.array([0.3, -0.2, 0.1])
    u = jnp.asarray(x - np.asarray(m.rest), jnp.float32)
    _, R = co.element_kinematics(m, u)
    f = np.asarray(co.internal_forces(m, u, R))
    scale = float(np.abs(np.asarray(m.ke)).max())
    assert np.abs(f).max() < scale * 1e-5


def test_stiffness_apply_matches_dense():
    """Matrix-free K_rot v equals explicitly assembled R Ke R^T."""
    nodes, tets = samples.two_tetra()
    m = _mesh(nodes, tets)
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.normal(size=(5, 3)) * 0.1, jnp.float32)
    v = rng.normal(size=(5, 3)).astype(np.float32)
    _, R = co.element_kinematics(m, u)
    out = np.asarray(co.stiffness_apply(m, R, jnp.asarray(v)))

    Rn, ke, tt = np.asarray(R), np.asarray(m.ke), np.asarray(m.tets)
    K = np.zeros((15, 15))
    for e in range(2):
        B = np.kron(np.eye(4), Rn[e])
        Kw = B @ ke[e] @ B.T
        idx = np.concatenate([[3 * n, 3 * n + 1, 3 * n + 2] for n in tt[e]])
        K[np.ix_(idx, idx)] += Kw
    ref = (K @ v.reshape(-1)).reshape(5, 3)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=np.abs(ref).max() * 1e-4)

    # Diagonal for the preconditioner.
    d = np.asarray(co.stiffness_diag(m, R)).reshape(-1)
    np.testing.assert_allclose(d, np.diag(K), rtol=2e-4, atol=np.abs(np.diag(K)).max() * 1e-4)


def test_pcg_solves_spd_system():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(24, 24))
    A = A @ A.T + 24 * np.eye(24)
    b = rng.normal(size=24)
    x, iters = integ.pcg(
        lambda v: jnp.asarray(A, jnp.float32) @ v,
        jnp.asarray(b, jnp.float32),
        jnp.asarray(np.diag(A), jnp.float32),
    )
    ref = np.linalg.solve(A, b)
    np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-3, atol=1e-4)
    assert int(iters) < 100


def test_gravity_settles_on_fixed_base():
    """TruthCube fixed at the bottom sags under gravity and settles."""
    nodes, tets = samples.truth_cube(3, 4, 3, 0.25)
    fixed = samples.bottom_nodes(nodes)
    m = _mesh(nodes, tets, fixed=fixed, E=1e7)
    deform = Deformable(m, h=0.0333, gravity=-1000.0, damping_stiffness=0.05)
    for _ in range(80):
        deform.timestep()
    q = np.asarray(deform.state.q)
    assert np.isfinite(q).all()
    # Fixed nodes pinned.
    np.testing.assert_allclose(q[fixed], 0.0, atol=1e-7)
    # Top nodes sag downward by a small fraction of the column height.
    top = nodes[:, 1] > nodes[:, 1].max() - 1e-6
    sag = q[top, 1]
    assert (sag < 0).all()
    assert -0.25 < sag.min() < -1e-4
    # Settles: velocity decays to near rest.
    v = np.asarray(deform.state.qvel)
    assert np.abs(v).max() < 0.1


def test_static_equilibrium_matches_linear_solve():
    """Small-load static limit: many implicit steps converge to K u = f."""
    nodes, tets = samples.two_tetra()
    fixed = np.array([0, 1, 2, 3])
    m = _mesh(nodes, tets, fixed=fixed, E=1e6)
    f = np.zeros((5, 3))
    f[4, 1] = -1000.0  # small push on the apex
    deform = Deformable(m, h=0.05, gravity=0.0)
    for _ in range(200):
        deform.timestep(f_haptic=f)
    u = np.asarray(deform.state.q)

    # Dense linear solve on the free DOF block (rotation ~ identity).
    ke, tt = np.asarray(m.ke), np.asarray(m.tets)
    K = np.zeros((15, 15))
    for e in range(2):
        idx = np.concatenate([[3 * n, 3 * n + 1, 3 * n + 2] for n in tt[e]])
        K[np.ix_(idx, idx)] += ke[e]
    free = np.arange(12, 15)
    u_ref = np.linalg.solve(K[np.ix_(free, free)], f.reshape(-1)[free])
    np.testing.assert_allclose(u[4], u_ref, rtol=0.05, atol=1e-5)


def test_ground_collision():
    nodes, tets = samples.two_tetra()
    nodes = nodes + np.array([0, 0.5, 0])  # float above ground
    m = _mesh(nodes, tets, E=1e6)
    deform = Deformable(m, h=0.0333, ground_y=0.0)
    for _ in range(60):
        deform.timestep()
    pos = np.asarray(deform.positions)
    assert pos[:, 1].min() > -1e-4  # nothing below the floor
    assert deform.stats()["n_collided"] >= 0


def test_haptic_ring_falloff():
    nodes, tets = samples.truth_cube(4, 4, 4, 0.5)
    adj = node_adjacency(tets, len(nodes))
    f = haptic_ring_forces(adj, len(nodes), np.array([0]),
                           np.array([[0.0, 100.0, 0.0]]), radius=3)
    assert np.allclose(f[0], [0, 100, 0])
    mags = np.linalg.norm(f, axis=1)
    assert (mags[mags > 0] <= 100.0 + 1e-6).all()
    # Some neighbors got a scaled share, far nodes got none.
    assert ((mags > 0) & (mags < 100)).any()
    assert (mags == 0).any()


def test_couple_surface_displacements():
    grid_to_node = jnp.asarray([0, 1, -1, 2])
    edge_nodes = jnp.asarray([[0, 1], [1, 3]])
    edge_t = jnp.asarray([0.25, 0.5])
    u = jnp.asarray([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    out = np.asarray(
        couple_surface_displacements(edge_nodes, edge_t, grid_to_node, u)
    )
    np.testing.assert_allclose(out[0], [0.75, 0.25, 0.0], atol=1e-6)
    np.testing.assert_allclose(out[1], [0.0, 0.5, 0.5], atol=1e-6)


def test_gradients_flow_to_material():
    """BASELINE config #5: image/positional gradients to material params —
    here d(tip displacement)/d(ke scale) exists via the implicit solve."""
    import dataclasses

    nodes, tets = samples.two_tetra()
    fixed = np.array([0, 1, 2, 3])
    m = _mesh(nodes, tets, fixed=fixed, E=1e6)
    f = jnp.zeros((5, 3)).at[4, 1].set(-1000.0)

    def tip_y(ke):
        mm = dataclasses.replace(m, ke=ke)
        st = FemState.rest(mm)
        for _ in range(5):
            st, _ = integ.timestep(mm, st, f, h=0.05, differentiable=True)
        return st.q[4, 1]

    g = jax.grad(tip_y)(m.ke)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).max() > 0
