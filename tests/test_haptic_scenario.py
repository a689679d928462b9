"""Haptic interaction loop end-to-end (VERDICT r1 item 10).

Scripted AvatarProbe push on a polygonized real scene, driven through the
gizmo translate path exactly like the reference's interaction stack:
GizmoManager.apply -> IGizmoListener.on_translate -> AvatarProbe.move_to
-> Deformable haptic forces -> implicit FEM step -> displacements
(reference: src/graphics/Gizmo.cpp -> AvatarProbe::onTranslate ->
Deformable::hapticSetCurrentForces -> applyHapticForces,
Deformable.cpp:342,634-706).
"""
import numpy as np

import jax.numpy as jnp

from fembrain.assets import MODELS_DIR
from fembrain.blob.reader import load_blob
from fembrain.fem.avatars import AvatarProbe
from fembrain.fem.deformable import Deformable
from fembrain.fem.tetmesh import build_fem_mesh
from fembrain.graphics.gizmo import GizmoManager, GizmoType
from fembrain.mesh.polygonize import extract_tet_mesh, grid_for_scene

SPHERE = str(MODELS_DIR / "blobtree" / "sphere.blob")


class _ProbeDriver:
    """Gizmo listener wiring the probe to the deformable (the reference's
    AvatarProbe::onTranslate role)."""

    def __init__(self, probe: AvatarProbe, deformable: Deformable,
                 rest: np.ndarray):
        self.probe = probe
        self.deformable = deformable
        self.rest = rest
        self.contacts = 0

    def on_translate(self, delta, pos):
        positions = self.rest + np.asarray(self.deformable.state.q)
        idx, forces = self.probe.move_to(pos, positions)
        self.contacts = len(idx)
        f = None
        if len(idx):
            f = self.deformable.haptic_forces(jnp.asarray(idx),
                                              jnp.asarray(forces))
        self.deformable.timestep(f_haptic=f)

    def on_rotate(self, quat):  # pragma: no cover
        pass

    def on_scale(self, scale):  # pragma: no cover
        pass


def test_haptic_probe_scenario_end_to_end():
    scene = load_blob(SPHERE).pack()
    grid = grid_for_scene(scene, 0.3)
    tm = extract_tet_mesh(
        scene, grid, ncap=grid.n_vertices, tetcap=grid.n_cells * 6
    )
    nn, nt = int(tm.n_nodes), int(tm.n_tets)
    nodes = np.asarray(tm.nodes)[:nn]
    tets = np.asarray(tm.tets)[:nt]
    fixed = np.nonzero(nodes[:, 1] < nodes[:, 1].min() + 1e-6)[0]
    fem = build_fem_mesh(nodes, tets, fixed=fixed)
    deformable = Deformable(fem, gravity=0.0, ground_y=None)

    # Probe starts just above the tissue top, then is dragged down into
    # it by scripted gizmo translations (probe force coeff like tumor.sim).
    top = nodes[:, 1].max()
    cx, cz = nodes[:, 0].mean(), nodes[:, 2].mean()
    probe = AvatarProbe(half_extents=np.array([0.25, 0.25, 0.25]),
                        force_coeff=5000.0,
                        pos=np.array([cx, top + 0.3, cz]))
    gm = GizmoManager()
    gm.gizmo_type = GizmoType.AVATAR
    gm.pos = probe.pos.copy()
    driver = _ProbeDriver(probe, deformable, nodes)
    gm.register(driver)

    total_contact_frames = 0
    for _ in range(12):
        gm.apply(np.array([0.0, -0.05, 0.0]))
        if driver.contacts:
            total_contact_frames += 1
    assert total_contact_frames >= 3, "probe never reached the tissue"

    q = np.asarray(deformable.state.q)
    assert np.isfinite(q).all()
    # Contacted top-region nodes are pushed DOWN.
    top_nodes = np.nonzero(nodes[:, 1] > top - 1e-6)[0]
    push = q[top_nodes, 1]
    assert push.min() < -1e-4, push
    # Fixed bottom never moves.
    assert np.abs(q[fixed]).max() < 1e-12
    # Displacement golden band: the scripted scenario is deterministic;
    # peak |q| was 1.380e-2 when recorded (probe 5000 N/m, 12 x 0.05 drag,
    # E = 1e7, reference penetration-depth force model — r5 probe parity:
    # force = coeff * max(dot(s_face - v, n_face), 0) along the contact
    # face normal, AvatarProbe.cpp:239-253; the old delta-spring model
    # peaked at 1.109e-3). Band guards the whole interaction stack.
    peak = float(np.abs(q).max())
    assert 5e-3 < peak < 5e-2, peak


def test_probe_force_direction_from_contact_geometry():
    """VERDICT r4 #7: with a DIAGONAL move delta, forces must point
    along the contact-face normal (reference AvatarProbe.cpp:239-253),
    not along the delta — the old model tiled coeff*delta. Synthetic
    wall of nodes at x = 0 so the contact geometry is unambiguous."""
    yy, zz = np.meshgrid(np.linspace(-1, 1, 9), np.linspace(-1, 1, 9))
    nodes = np.stack(
        [np.zeros(yy.size), yy.ravel(), zz.ravel()], 1
    )
    probe = AvatarProbe(half_extents=np.array([0.3, 0.3, 0.3]),
                        force_coeff=1000.0,
                        pos=np.array([0.7, 0.0, 0.0]))
    idx = np.zeros(0)
    forces = np.zeros((0, 3))
    for _ in range(8):
        # Diagonal drag: -x into the wall plus a -y slide.
        target = probe.pos + np.array([-0.08, -0.02, 0.0])
        idx, forces = probe.move_to(target, nodes)
        if len(idx):
            break
    assert len(idx) > 0, "probe never contacted the wall"
    assert probe.contact_face == 0, probe.contact_face
    # First touch can have ~zero penetration; push deeper so the face
    # plane passes the wall nodes.
    f0 = np.abs(forces[:, 0]).max()
    _, forces = probe.move_to(probe.pos + np.array([-0.08, -0.02, 0]),
                              nodes)
    # Contact through the box's LEFT (-x) face: forces along (-1, 0, 0)
    # with per-vertex penetration magnitudes — zero y/z components even
    # though the move delta has a y component.
    assert probe.contact_face == 0
    assert np.all(forces[:, 0] <= 0.0)
    assert np.abs(forces[:, 1:]).max() == 0.0
    assert np.abs(forces[:, 0]).max() > max(f0, 0.0)
    # Releasing the grip clears the sticky face and the vertex hash.
    probe.clear_contact()
    assert probe.contact_face == -1 and not probe._contacts


def test_probe_pick_mode_matches_reference():
    """Pick mode: coeff_pick * delta on the single picked node
    (AvatarProbe.cpp:133-143, force x10000)."""
    probe = AvatarProbe(pos=np.zeros(3))
    probe.pick_mode = True
    probe.picked_node = 7
    idx, forces = probe.move_to(np.array([0.01, -0.02, 0.0]),
                                np.zeros((10, 3)))
    assert list(idx) == [7]
    np.testing.assert_allclose(forces[0], [100.0, -200.0, 0.0],
                               rtol=1e-12)
