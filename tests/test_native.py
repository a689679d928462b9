"""Native femcore (C++) vs pure-Python equivalence tests."""
import numpy as np
import pytest

from fembrain.assets import MODELS_DIR
from fembrain import native
from fembrain.fem.deformable import haptic_ring_forces, node_adjacency
from fembrain.mesh import samples
from fembrain.mesh.volmesh import CELL_EDGES, VolMesh

lib = native.load()
pytestmark = pytest.mark.skipif(lib is None, reason="no C++ toolchain")


def test_native_ring_forces_match_python():
    nodes, tets = samples.truth_cube(4, 4, 4, 0.5)
    adj = node_adjacency(tets, len(nodes))
    contacts = np.array([0, 37])
    forces = np.array([[0.0, 100.0, 0.0], [5.0, 0.0, -2.0]])
    ref = haptic_ring_forces(adj, len(nodes), contacts, forces, radius=4)
    nat = native.NativeAdjacency(tets, len(nodes))
    out = nat.ring_forces(contacts, forces, radius=4)
    np.testing.assert_allclose(out, ref, atol=1e-12)


def test_native_edges_match_volmesh():
    nodes, tets = samples.truth_cube(3, 3, 3, 0.5)
    res = native.build_edges(tets)
    assert res is not None
    edges, cell_edges = res
    vm = VolMesh(nodes, tets)
    assert len(edges) == vm.count_edges()
    # Same canonical slots: edge endpoints match per cell slot.
    for t in range(len(tets)):
        for s, (a, b) in enumerate(CELL_EDGES):
            e = edges[cell_edges[t, s]]
            assert {int(e[0]), int(e[1])} == {tets[t, a], tets[t, b]}


def test_native_check_cells():
    nodes, tets = samples.truth_cube(3, 3, 3, 0.5)
    assert native.check_cells(tets, nodes, len(nodes)) == 0
    bad = tets.copy()
    bad[0, 1] = bad[0, 0]  # duplicate corner
    assert native.check_cells(bad, nodes, len(nodes)) == 1


def test_native_components():
    nodes, tets = samples.two_tetra()
    n, labels = native.components(tets, len(nodes))
    assert n == 1
    # Two disconnected tets.
    nodes2 = np.vstack([nodes, nodes + 10.0])
    tets2 = np.vstack([tets[:1], tets[:1] + len(nodes)])
    n2, labels2 = native.components(tets2, len(nodes2))
    assert n2 == 2 and labels2[0] != labels2[1]


def test_native_performance_large_mesh():
    """Native adjacency handles the reference's 32k-tet export quickly."""
    from pathlib import Path

    veg = MODELS_DIR / "blobtree" / "tumor.veg"
    if not veg.exists():
        pytest.skip("no reference asset")
    from fembrain.mesh.io import read_veg
    import time

    nodes, tets, _ = read_veg(veg)
    t0 = time.perf_counter()
    nat = native.NativeAdjacency(tets, len(nodes))
    f = nat.ring_forces(np.array([100]), np.array([[0, 1e4, 0.0]]), 5)
    dt = time.perf_counter() - t0
    assert (f != 0).any()
    assert dt < 2.0  # native build+query is fast even for 32k tets
