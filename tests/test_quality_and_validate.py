"""Scene validation, mesh quality metrics, field image/off-surface utils,
scan-fold vs unrolled-fold equivalence."""
import numpy as np
import pytest

import jax.numpy as jnp

from fembrain.assets import MODELS_DIR
from fembrain.blob.reader import load_blob
from fembrain.blob.scene import OpDef, PrimDef, SceneDef
from fembrain.blob.types import OpType, PrimType
from fembrain.mesh import samples
from fembrain.mesh.polygonize import default_caps, grid_for_scene, polygonize
from fembrain.mesh.quality import tet_quality, triangle_quality
from fembrain.ops import field as jfield

BLOB = str(MODELS_DIR / "blobtree")


def test_scene_validate():
    sc = load_blob(f"{BLOB}/tumor.blob")
    assert sc.validate() == []
    bad = SceneDef()
    bad.add_prim(PrimDef(PrimType.POINT))
    bad.add_op(OpDef(OpType.BLEND, left=0, right=7))  # right out of range
    bad.root_is_op, bad.root_idx = True, 0
    assert bad.validate() != []


def test_triangle_quality_metrics():
    scene = load_blob(f"{BLOB}/sphere.blob").pack()
    grid = grid_for_scene(scene, 0.1)
    mesh = polygonize(scene, grid, *default_caps(grid))
    nv, nt = int(mesh.n_verts), int(mesh.n_tris)
    q = triangle_quality(np.asarray(mesh.verts)[:nv], np.asarray(mesh.tris)[:nt])
    assert q["count"] == nt
    assert q["degenerate"] <= nt * 0.02
    assert 0.3 < q["quality_mean"] <= 1.0


def test_tet_quality_metrics():
    nodes, tets = samples.truth_cube(3, 3, 3, 0.5)
    q = tet_quality(nodes, tets)
    assert q["inverted"] == 0 and q["degenerate"] == 0
    np.testing.assert_allclose(q["volume_total"], 1.0, rtol=1e-9)
    assert q["aspect_max"] < 10


def test_field_image_slice():
    scene = load_blob(f"{BLOB}/sphere.blob").pack()
    img = np.asarray(jfield.field_image(scene, axis=2, coord=0.0,
                                        width=33, height=33))
    assert img.shape == (33, 33)
    # Center of the slice passes through the blob center: max field there.
    assert img[16, 16] == img.max()
    # Slice spans exactly the support bbox: corners are weak, center peaks.
    assert img.max() > 0.9 and img.min() < 0.2


def test_off_surface_points():
    scene = load_blob(f"{BLOB}/sphere.blob").pack()
    r = float(np.sqrt(1 - 0.5 ** (1 / 3)))
    on = np.array([[r, 0, 0], [0, r, 0.0]], np.float32)
    pts, vals = jfield.off_surface_points_and_fields(scene, jnp.asarray(on),
                                                     offset=0.05)
    vals = np.asarray(vals)
    # Outward points have lower field, inward higher.
    assert (vals[:2] < 0.5).all() and (vals[2:] > 0.5).all()


def test_scan_fold_matches_unrolled(monkeypatch):
    """The register-file lax.scan fold == trace-time unrolled fold."""
    sc = load_blob(f"{BLOB}/complex.blob")  # 11 ops, mixed types
    scene = sc.pack()
    pts = np.random.default_rng(0).uniform(-2, 2, (64, 3)).astype(np.float32)
    f_unrolled = np.asarray(jfield.field(scene, pts))
    monkeypatch.setattr(jfield, "UNROLL_LIMIT", 0)
    f_scan = np.asarray(jfield.field(scene, pts))
    np.testing.assert_allclose(f_scan, f_unrolled, atol=1e-6)
