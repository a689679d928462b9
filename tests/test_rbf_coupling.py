"""RBF wired into the deformed pipeline (VERDICT r1 missing #2): after
deformation the refit FastRBF's zero level must track the DEFORMED
surface, so collision/haptics can query deformed tissue (reference
RBF.h:51-136 + ComputeOffSurfacePointsAndFields)."""
import numpy as np

import jax.numpy as jnp

from fembrain.assets import MODELS_DIR
from fembrain.app import SimulationApp
from fembrain.fem.deformable import couple_surface_displacements
from fembrain.fem.integrator import FemState


def test_rbf_tracks_deformed_surface(tmp_path):
    app = SimulationApp(str(MODELS_DIR / "sphere.sim"),
                        cellsize=0.3)
    n = app.fem.n_nodes
    # Synthetic uniform sag: every free node down by 0.15 (larger than
    # the fit accuracy, smaller than the mesh).
    dq = jnp.zeros((n, 3)).at[:, 1].add(-0.15)
    free = ~np.asarray(app.fem.fixed)
    dq = jnp.where(jnp.asarray(free)[:, None], dq, 0.0)
    app.deformable.state = FemState(
        q=dq, qvel=jnp.zeros_like(dq), dv=jnp.zeros_like(dq)
    )

    rbf = app.refit_rbf(max_points=200)
    assert rbf.centers.shape[0] > 0

    disp = couple_surface_displacements(
        app.surface.edge_nodes, app.surface.edge_t,
        app._grid_to_node, app.deformable.state.q,
    )
    nv = int(app.surface.n_verts)
    deformed = np.asarray(app.surface.verts + disp)[:nv]
    rest = np.asarray(app.surface.verts)[:nv]

    # Zero level sits on the deformed surface...
    on = np.asarray(rbf.evaluate(deformed))
    assert np.abs(on).mean() < 0.02, np.abs(on).mean()

    # ...and NOT on the rest surface where it moved: the vacated band
    # above the sagged top now reads as outside (negative).
    top = rest[:, 1] > rest[:, 1].max() - 0.05
    vacated = np.asarray(rbf.evaluate(rest[top]))
    assert vacated.mean() < -0.05, vacated.mean()

    # Collision/haptic query semantics: a probe point just above the
    # deformed top is outside; just below it is inside.
    ytop_def = deformed[:, 1].max()
    cx, cz = deformed[:, 0].mean(), deformed[:, 2].mean()
    probe_out = np.array([[cx, ytop_def + 0.12, cz]])
    probe_in = np.array([[cx, ytop_def - 0.25, cz]])
    assert float(rbf.evaluate(probe_out)[0]) < 0
    assert float(rbf.evaluate(probe_in)[0]) > 0
