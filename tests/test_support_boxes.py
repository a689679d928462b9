"""Conservativeness of per-primitive support AABBs (the culling oracle).

If prim_support_aabb under-covered a primitive's Wyvill support, ray
interval culling (render/sphere_trace.prim_interval) could silently drop
hits — so we property-test: at any point outside ALL support boxes the
total field must be exactly zero (each op folds below the sum of prim
fields, ops/field.py).
"""
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

from fembrain.assets import MODELS_DIR
from fembrain.blob.reader import load_blob
from fembrain.ops.field import field

BLOB_DIR = MODELS_DIR / "blobtree"

SCENES = ["sphere", "tumor", "ventricle", "CylinderWithHoles", "SphereCube",
          "TwoTriangles", "disk", "cake", "testDisc2", "spheredif"]


@pytest.mark.parametrize("name", SCENES)
def test_field_zero_outside_support_boxes(name):
    sc = load_blob(BLOB_DIR / f"{name}.blob")
    sc.flatten_instances()
    scene = sc.pack()
    lo = np.asarray(scene.prim_bb_lo)
    hi = np.asarray(scene.prim_bb_hi)

    rng = np.random.default_rng(0)
    glo, ghi = lo.min(0) - 1.0, hi.max(0) + 1.0
    pts = rng.uniform(glo, ghi, size=(4000, 3)).astype(np.float32)
    inside_any = np.zeros(len(pts), bool)
    for j in range(lo.shape[0]):
        inside_any |= ((pts >= lo[j]) & (pts <= hi[j])).all(1)
    outside = pts[~inside_any]
    if len(outside) == 0:
        pytest.skip("boxes cover the whole sample domain")
    f = np.asarray(field(scene, jnp.asarray(outside)))
    assert np.abs(f).max() == 0.0


def test_support_boxes_cover_heuristic_boxes_center():
    """Support boxes contain each prim's skeleton position."""
    sc = load_blob(BLOB_DIR / "ventricle.blob")
    sc.flatten_instances()
    scene = sc.pack()
    lo = np.asarray(scene.prim_bb_lo)[: scene.n_prims]
    hi = np.asarray(scene.prim_bb_hi)[: scene.n_prims]
    assert (hi - lo).min() > 0.0
