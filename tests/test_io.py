"""Mesh I/O tests: Vega .veg round-trip + reading the reference's own
exported .veg assets; OBJ round-trip."""
from pathlib import Path

import numpy as np
import pytest

from fembrain.assets import MODELS_DIR
from fembrain.mesh import io as mio
from fembrain.mesh import samples

REF_VEG = MODELS_DIR / "blobtree" / "tumor.veg"


def test_veg_roundtrip(tmp_path):
    nodes, tets = samples.truth_cube(3, 3, 3, 0.5)
    p = tmp_path / "cube.veg"
    mio.write_veg(p, nodes, tets, density=1000, E=1e7, nu=0.45)
    n2, t2, mat = mio.read_veg(p)
    np.testing.assert_allclose(n2, nodes, atol=1e-5)
    np.testing.assert_array_equal(t2, tets)
    assert mat["E"] == 1e7 and mat["nu"] == 0.45 and mat["density"] == 1000


@pytest.mark.skipif(not REF_VEG.exists(), reason="reference assets absent")
def test_read_reference_veg():
    nodes, tets, mat = mio.read_veg(REF_VEG)
    assert nodes.shape == (7948, 3)
    assert tets.shape == (32303, 4)
    assert tets.min() >= 0 and tets.max() < len(nodes)
    assert mat["E"] == 1e7
    # NOTE: the reference's own export contains 524 degenerate and 2
    # inverted tets (its GPU tetrahedralizer emits them); we only check
    # the file parses fully and the vast majority are sound.
    a, b, c, d = (nodes[tets[:, i]] for i in range(4))
    vols = np.einsum("ij,ij->i", b - a, np.cross(c - a, d - a)) / 6
    assert (np.abs(vols) > 1e-12).mean() > 0.97


def test_obj_roundtrip(tmp_path):
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.0]])
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    p = tmp_path / "m.obj"
    mio.write_obj(p, verts, tris, normals=np.tile([0, 0, 1.0], (4, 1)))
    v2, t2 = mio.read_obj(p)
    np.testing.assert_allclose(v2, verts, atol=1e-6)
    np.testing.assert_array_equal(t2, tris)
