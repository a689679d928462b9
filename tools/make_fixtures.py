"""Generate the small BlobTree test scenes under data/models/blobtree/.

The scenes are synthesized (the original FemBrain scene files are not
shipped here) in the spirit of its sphere / spheredif / tumor scenes:

* sphere.blob:    one unit point primitive at the origin (iso radius
                  sqrt(1 - 0.5^(1/3)), the analytic sphere the tests use);
* spheredif.blob: a DIFFERENCE of two points: a non-additive scene, so
                  the trace kernel's generic path (every prim per step,
                  folded along the op schedule);
* tumor.blob:     a 10-prim blend of points around a cylinder: the
                  additive, block-culled kernel path with mixed types;
* sphere.sim, tumor.sim: app configs for the two scenes (tumor.sim keeps
                  the original's cellsize, fixed vertices and force).

Run: python tools/make_fixtures.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fembrain.blob.scene import OpDef, PrimDef, SceneDef
from fembrain.blob.types import OpType, PrimType
from fembrain.blob.writer import save_blob
from fembrain.utils.affine import compose_trs
from fembrain.utils.config import SimConfig


def _point(sc: SceneDef, center, scale, color=(0.8, 0.55, 0.55, 1.0)):
    p = PrimDef(PrimType.POINT, color=np.asarray(color, float))
    p.affine = (tuple(scale), (0, 0, 0, 1), tuple(center))
    p.fwd, p.bwd = compose_trs(center, (0, 0, 0, 1), scale)
    return sc.add_prim(p)


def make_sphere() -> SceneDef:
    sc = SceneDef(name="sphere")
    _point(sc, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    sc.root_is_op, sc.root_idx = False, 0
    return sc


def make_spheredif() -> SceneDef:
    sc = SceneDef(name="spheredif")
    a = _point(sc, (0.0, 0.0, 0.0), (1.6, 1.6, 1.6))
    b = _point(sc, (0.55, 0.25, 0.0), (1.1, 1.1, 1.1))
    sc.add_op(OpDef(OpType.DIF, left=a, right=b))
    sc.root_is_op, sc.root_idx = True, 0
    return sc


def make_tumor(seed: int = 3) -> SceneDef:
    rng = np.random.default_rng(seed)
    sc = SceneDef(name="tumor")
    for k in range(9):
        th = 2 * np.pi * k / 9
        center = (1.1 * np.cos(th), 0.35 * np.sin(2 * th), 1.1 * np.sin(th))
        s = 1.3 + rng.uniform(-0.2, 0.2)
        _point(sc, center, (s, 0.9 * s, s),
               (0.75, 0.5 + 0.05 * (k % 3), 0.5, 1.0))
    stem = PrimDef(
        PrimType.CYLINDER,
        pos=np.array([0.0, -1.6, 0.0]),
        dir=np.array([0.0, 1.0, 0.0]),
        res=np.array([0.35, 1.2, 0, 0]),
        color=np.array([0.7, 0.6, 0.55, 1.0]),
    )
    stem.affine = ((1, 1, 1), (0, 0, 0, 1), (0, 0, 0))
    sc.add_prim(stem)
    sc.add_op(OpDef(OpType.BLEND, left=0, right=len(sc.prims) - 1,
                    is_range=True))
    sc.root_is_op, sc.root_idx = True, 0
    return sc


SIMS = {
    "sphere": SimConfig(input_file="blobtree/sphere.blob", cellsize=0.14,
                        gravity=True, cam_zoom=3.0),
    "tumor": SimConfig(input_file="blobtree/tumor.blob", cellsize=0.19,
                       fixed_vertices=[7, 7, 7, 3, 6], force_coeff=5000.0,
                       cam_zoom=7.0),
}


def main() -> None:
    models = Path(__file__).resolve().parent.parent / "data" / "models"
    out = models / "blobtree"
    out.mkdir(parents=True, exist_ok=True)
    for make in (make_sphere, make_spheredif, make_tumor):
        sc = make()
        save_blob(sc, out / f"{sc.name}.blob")
        print(f"wrote {out / (sc.name + '.blob')} ({len(sc.prims)} prims)")
    for name, cfg in SIMS.items():
        cfg.save(models / f"{name}.sim")
        print(f"wrote {models / (name + '.sim')}")


if __name__ == "__main__":
    main()
