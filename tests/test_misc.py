"""Misc parity modules: collision detection, gnuplot driver, volume
reader, turntable viewer, brain asset."""
import json
from pathlib import Path

import numpy as np
import pytest

from fembrain.assets import MODELS_DIR
from fembrain.fem.collision import AABB, CollisionDetection
from fembrain.mesh.minc import Volume, read_volume, write_volume
from fembrain.utils.metrics import MetricsLogger, Record
from fembrain.utils.plots import write_gnuplot


def test_collision_detection():
    cd = CollisionDetection()
    cd.update("a", np.array([[0, 0, 0], [1, 1, 1.0]]))
    cd.update("b", np.array([[0.5, 0.5, 0.5], [2, 2, 2.0]]))
    cd.update("c", np.array([[5, 5, 5], [6, 6, 6.0]]))
    assert cd.overlaps() == [("a", "b")]
    pts = np.array([[0.7, 0.7, 0.7], [9, 9, 9.0]])
    assert list(cd.vertices_inside("b", pts)) == [0]
    box = AABB.of_points(pts, pad=0.1)
    assert box.contains([0.7, 0.7, 0.7]).all()


def test_gnuplot_driver(tmp_path):
    ml = MetricsLogger(jsonl_path=tmp_path / "m.jsonl")
    for i in range(4):
        ml.append(Record(fps=30 + i, ms_anim_total_frame=33.0))
    ml.close()
    gp = write_gnuplot(tmp_path / "m.jsonl", tmp_path / "perf")
    assert gp.exists()
    assert "plot" in gp.read_text()
    dat = (tmp_path / "perf.dat").read_text().splitlines()
    assert len(dat) == 5  # header + 4 rows


def test_volume_roundtrip(tmp_path):
    vol = Volume(
        np.arange(24, dtype=np.float32).reshape(2, 3, 4),
        spacing=(1, 2, 3),
        origin=(0.5, 0, 0),
    )
    write_volume(tmp_path / "v.raw", vol)
    v2 = read_volume(tmp_path / "v.raw")
    np.testing.assert_array_equal(v2.data, vol.data)
    assert v2.spacing == (1.0, 2.0, 3.0)


def test_brain_asset_loads():
    p = Path("data/models/blobtree/brain.blob")
    assert p.exists(), "run tools/make_brain.py"
    from fembrain.blob.reader import load_blob

    sc = load_blob(p)
    scene = sc.pack()
    assert scene.n_prims > 100
    # Field is substantial at the centroid.
    import jax.numpy as jnp

    from fembrain.ops.field import field

    c = 0.5 * (scene.bbox_lo + scene.bbox_hi)
    assert float(field(scene, c[None])[0]) > 0.5


def test_turntable_viewer(tmp_path):
    from fembrain.blob.reader import load_blob
    from fembrain.render.viewer import render_turntable

    scene = load_blob(
        str(MODELS_DIR / "blobtree" / "sphere.blob")
    ).pack()
    paths = render_turntable(scene, tmp_path, frames=2, width=64, height=48)
    assert len(paths) == 2 and all(p.exists() for p in paths)
