"""Scene graph, gizmo routing, surface mesh picking, Catmull-Rom spline."""
import numpy as np
import pytest

from fembrain.graphics import (
    CatmullRom,
    GizmoManager,
    GizmoType,
    SceneGraph,
    SGMesh,
    SGNode,
    SurfaceMesh,
)
from fembrain.graphics.gizmo import GizmoAxis
from fembrain.render.camera import Camera


def _tri_mesh(name="tri"):
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], float)
    faces = np.array([[0, 1, 2]], np.int32)
    return SGMesh(name, verts, faces)


# ---------------------------------------------------------------- scenegraph
def test_scenegraph_add_get_remove():
    sg = SceneGraph()
    m = sg.add(_tri_mesh("a"))
    sg.add(_tri_mesh("b"))
    assert len(sg) == 2
    assert sg.get("a") is m
    assert sg.remove("a")
    assert sg.get("a") is None
    assert not sg.remove("a")


def test_scenegraph_draw_respects_visibility_and_transform():
    sg = SceneGraph()
    m = sg.add(_tri_mesh("a"))
    hidden = sg.add(_tri_mesh("hidden"))
    hidden.visible = False
    m.set_translation([5.0, 0.0, 0.0])
    batches = sg.draw()
    assert [b.name for b in batches] == ["a"]
    np.testing.assert_allclose(batches[0].verts[0], [5.0, 0.0, 0.0])
    assert "fps" in sg.headers


def test_scenegraph_timestep_fanout():
    calls = []

    class Stepper(SGNode):
        def timestep(self):
            calls.append(self.name)

    sg = SceneGraph()
    sg.add(Stepper("x"))
    frozen = sg.add(Stepper("frozen"))
    frozen.animate = False
    sg.timestep()
    assert calls == ["x"]


def test_scenegraph_aabb_union():
    sg = SceneGraph()
    sg.add(_tri_mesh("a"))
    b = sg.add(_tri_mesh("b"))
    b.set_translation([10.0, 0.0, 0.0])
    lo, hi = sg.aabb()
    assert lo[0] == 0.0 and hi[0] == 11.0


def test_screen_to_world_ray_center_points_at_target():
    sg = SceneGraph()
    sg.camera = Camera.make(eye=[0.0, 0.0, 5.0], target=[0.0, 0.0, 0.0])
    ro, rd = sg.screen_to_world_ray(32, 32, 64, 64)
    np.testing.assert_allclose(ro, [0, 0, 5.0], atol=1e-6)
    # Central pixel ray points roughly towards -z.
    assert rd[2] < -0.99


# -------------------------------------------------------------------- gizmo
def test_gizmo_translate_moves_focused_node_and_notifies():
    sg_mesh = _tri_mesh()
    gm = GizmoManager()
    gm.set_focused(sg_mesh)
    seen = []

    class Listener:
        def on_translate(self, delta, pos):
            seen.append((delta.copy(), pos.copy()))

        def on_rotate(self, q):
            pass

        def on_scale(self, s):
            pass

    gm.register(Listener())
    gm.axis = GizmoAxis.X
    pos = gm.apply([1.0, 2.0, 3.0])  # axis mask keeps only x
    np.testing.assert_allclose(pos, [1.0, 0.0, 0.0])
    np.testing.assert_allclose(sg_mesh.translation(), [1.0, 0.0, 0.0])
    assert len(seen) == 1
    np.testing.assert_allclose(seen[0][0], [1.0, 0.0, 0.0])


def test_gizmo_rotate_emits_unit_quaternion():
    gm = GizmoManager()
    gm.gizmo_type = GizmoType.ROTATE
    got = []

    class L:
        def on_translate(self, d, p):
            pass

        def on_rotate(self, q):
            got.append(q)

        def on_scale(self, s):
            pass

    gm.register(L())
    gm.apply([0.0, 0.0, np.pi / 2])  # 90 deg about z
    (q,) = got
    np.testing.assert_allclose(np.linalg.norm(q), 1.0, atol=1e-12)
    np.testing.assert_allclose(q[2], np.sin(np.pi / 4), atol=1e-12)


# ------------------------------------------------------------- surface mesh
def test_surface_mesh_pick_and_fixed(tmp_path):
    verts = np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0]], float)
    faces = np.array([[0, 1, 2]], np.int32)
    sm = SurfaceMesh("s", verts, faces)
    # Ray along -z passing near vertex 1.
    i = sm.pick_vertex(ro=[2.05, 0.0, 5.0], rd=[0, 0, -1.0])
    assert i == 1
    assert sm.pick_vertex(ro=[50, 50, 5.0], rd=[0, 0, -1.0]) == -1
    assert sm.toggle_fixed(1) and not sm.toggle_fixed(1)
    idx = sm.pick_vertices_in_sphere([0, 0, 0], 0.5)
    assert list(idx) == [0]

    p = tmp_path / "m.obj"
    sm.save_obj(p)
    sm2 = SurfaceMesh.from_obj(p)
    np.testing.assert_allclose(sm2.verts, verts, atol=1e-6)


# ------------------------------------------------------------------- spline
def test_catmull_rom_interpolates_control_points():
    pts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], float)
    sp = CatmullRom(pts)
    for i in range(len(pts) - 1):
        np.testing.assert_allclose(sp.position(float(i)), pts[i], atol=1e-12)
    np.testing.assert_allclose(
        sp.position(float(sp.n_segments) - 1e-12), pts[-1], atol=1e-6
    )


def test_catmull_rom_closed_wraps():
    pts = np.array([[1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0]], float)
    sp = CatmullRom(pts, closed=True)
    assert sp.n_segments == 4
    np.testing.assert_allclose(sp.position(4.0 - 1e-12), pts[0], atol=1e-6)
    assert sp.total_length > 4.0  # longer than the inscribed square


def test_catmull_rom_uniform_speed():
    pts = np.array([[0, 0, 0], [1, 0, 0], [3, 0, 0]], float)
    sp = CatmullRom(pts)
    L = sp.total_length
    p_half = sp.position_at_length(L / 2)
    np.testing.assert_allclose(p_half[1:], 0.0, atol=1e-9)
    assert 1.0 < p_half[0] < 2.0


def test_spline_rejects_single_point():
    with pytest.raises(ValueError):
        CatmullRom([[0, 0, 0]])


# ------------------------------------------------------------------- raster
def test_rasterize_triangle_visible_and_depth_ordered():
    from fembrain.graphics.raster import rasterize
    from fembrain.graphics.scenegraph import DrawBatch

    cam = Camera.make(eye=[0.0, 0.0, 5.0], target=[0.0, 0.0, 0.0])
    near = DrawBatch(
        "near",
        np.array([[-1, -1, 1.0], [1, -1, 1.0], [0, 1, 1.0]]),
        np.array([[0, 1, 2]], np.int32),
        color=(1.0, 0.0, 0.0, 1.0),
    )
    far = DrawBatch(
        "far",
        np.array([[-2, -2, -1.0], [2, -2, -1.0], [0, 2, -1.0]]),
        np.array([[0, 1, 2]], np.int32),
        color=(0.0, 0.0, 1.0, 1.0),
    )
    img = rasterize([far, near], cam, 80, 60)
    center = img[30, 40]
    assert center[0] > center[2]  # near (red) wins the depth test
    assert (img != 1.0).any()


def test_rasterize_points_and_scenegraph_integration():
    from fembrain.graphics.raster import rasterize

    sg = SceneGraph()
    sg.camera = Camera.make(eye=[0.0, 0.0, 4.0], target=[0.0, 0.0, 0.0])
    sg.add(_tri_mesh("t"))
    cloud = SGMesh("cloud", np.array([[0.5, 0.5, 0.0]]), None,
                   color=(0.0, 1.0, 0.0, 1.0))
    sg.add(cloud)
    img = rasterize(sg.draw(), sg.camera, 64, 48)
    assert img.shape == (48, 64, 3)
    assert (img != 1.0).any()
