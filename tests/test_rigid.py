"""Rigid environment: falling box vs floor and vs soft tissue (the
reference's Bullet demo staging, main.cpp:685-712,863-870, without
Bullet — fem.rigid penalty contact)."""
import numpy as np

import jax
import jax.numpy as jnp

from fembrain.fem import rigid
from fembrain.fem.integrator import FemState
from fembrain.fem.rigid import RigidBoxState
from fembrain.fem.tetmesh import build_fem_mesh
from fembrain.mesh import samples

HE = np.array([0.2, 0.2, 0.2])


def test_box_falls_and_rests_on_floor():
    st = RigidBoxState.at_rest([0.0, 2.0, 0.0])
    step = jax.jit(
        lambda s: rigid.rigid_step(s, HE, mass=1.0, h=0.01, ground_y=0.0)
    )
    for _ in range(400):
        st = step(st)
    # Rests with its bottom face on the floor.
    assert abs(float(st.pos[1]) - 0.2) < 1e-3
    assert abs(float(st.vel[1])) < 0.05


def test_box_deforms_tissue_and_gets_supported():
    """Drop a box onto a fixed-bottom truth cube: the tissue dents under
    the box and the box decelerates to rest ABOVE the floor (supported by
    tissue reaction), closing the falling-cube-vs-tissue behavior."""
    n = 5
    nodes, tets = samples.truth_cube(n, n, n, 0.1)  # 0.4^3 cube at origin
    mesh = build_fem_mesh(nodes, tets, fixed=samples.bottom_nodes(nodes))
    top = float(np.asarray(mesh.rest)[:, 1].max())
    cx = float(np.asarray(mesh.rest)[:, 0].mean())
    cz = float(np.asarray(mesh.rest)[:, 2].mean())

    box = RigidBoxState.at_rest([cx, top + 0.5, cz])
    fem_state = FemState.rest(mesh)

    step = jax.jit(
        lambda b, s: rigid.coupled_box_tissue_step(
            b, HE, 20.0, mesh, s, h=0.005, ground_y=-1.0
        )
    )
    min_bottom = 1e9
    for _ in range(300):
        box, fem_state, _ = step(box, fem_state)
        min_bottom = min(min_bottom, float(box.pos[1]) - HE[1])

    q = np.asarray(fem_state.q)
    assert np.isfinite(q).all()
    # Tissue dented downward under the box (E = 1e7: dents are small).
    assert q[:, 1].min() < -2e-5
    # Box never reached the floor: tissue carried it.
    assert min_bottom > -0.9
    # And it ended up near the (dented) tissue top, not in free fall.
    assert float(box.pos[1]) - HE[1] < top + 0.05
    assert float(box.pos[1]) - HE[1] > top - 0.2


# ------------------------------------------------------------- 6-DOF (r4)

def test_free_rotation_preserves_angular_velocity():
    """No torque: a symmetric box spinning about a principal axis keeps
    its angular velocity; the quaternion stays unit."""
    import jax.numpy as jnp

    from fembrain.fem.rigid import RigidBody6State, rigid_step_6dof

    st = RigidBody6State.at_rest((0.0, 5.0, 0.0), omega=(0.0, 2.0, 0.0))
    for _ in range(50):
        st = rigid_step_6dof(st, (0.3, 0.2, 0.1), 1.0, 0.01,
                             ground_y=None)
    assert abs(float(jnp.linalg.norm(st.quat)) - 1.0) < 1e-5
    # principal-axis spin: omega unchanged (gyroscopic term vanishes)
    assert abs(float(st.omega[1]) - 2.0) < 1e-4
    # the box fell freely meanwhile
    assert float(st.vel[1]) < -4.0


def test_tumbling_box_settles_on_floor():
    """A tilted falling box touches the floor off-center -> corner
    penalties torque it; it ends up resting with its bottom face near the
    ground and rotation damped out."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    from fembrain.fem.rigid import (
        RigidBody6State, quat_to_mat, rigid_step_6dof,
    )

    q0 = np.asarray([np.cos(0.15), 0.0, 0.0, np.sin(0.15)])  # z-tilt
    st = RigidBody6State.at_rest((0.0, 1.0, 0.0), quat=q0)
    he = (0.3, 0.2, 0.25)

    @jax.jit
    def run(st):
        def body(st, _):
            # h*sqrt(k/m) must stay well under 2 for the explicit corner
            # penalty (h=0.005, k=2e4 pumps energy and launches the box).
            return rigid_step_6dof(st, he, 1.0, 0.002, ground_y=0.0,
                                   ground_stiffness=5e3), None
        st, _ = jax.lax.scan(body, st, None, length=5000)
        return st

    st = run(st)
    assert abs(float(jnp.linalg.norm(st.quat)) - 1.0) < 1e-4
    assert float(jnp.linalg.norm(st.omega)) < 0.5        # spun down
    # resting height ~ a face-down half extent (some penalty sink-in)
    assert 0.1 < float(st.pos[1]) < 0.4
    # a body axis is now nearly vertical (settled flat)
    R = np.asarray(quat_to_mat(st.quat))
    assert np.abs(R[1]).max() > 0.95, R[1]


def test_offcenter_tissue_contact_spins_box():
    """Tissue nodes contacting one side of the box produce torque
    (reference Bullet cube interaction is 6-DOF)."""
    import numpy as np

    import jax.numpy as jnp

    from fembrain.fem.rigid import (
        RigidBody6State, box_tissue_forces_6dof,
    )

    st = RigidBody6State.at_rest((0.0, 0.0, 0.0))
    nodes = jnp.asarray(np.asarray([[0.25, 0.15, 0.0]]))  # one off-center
    f_n, f_b, tau = box_tissue_forces_6dof(st, (0.3, 0.3, 0.3), nodes)
    assert float(jnp.linalg.norm(f_n)) > 0
    np.testing.assert_allclose(np.asarray(f_b), -np.asarray(f_n[0]),
                               atol=1e-6)
    assert float(jnp.linalg.norm(tau)) > 0  # off-center -> torque
