"""Generate a brain-like BlobTree scene (data/models/brain.blob + .sim).

The reference repo strips its large brain assets (.MISSING_LARGE_BLOBS
lists brain.obj/brain.blend); BASELINE config #3 needs a "full brain
BlobTree scene", so we synthesize one procedurally in the same spirit as
the shipped tumor/ventricle scenes: two cortical hemispheres built from
blended point primitives arranged on gyri-like bands, a cerebellum, and a
brainstem cylinder — ~220 primitives under one BLEND range op.
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


def make_brain(seed: int = 7) -> SceneDef:
    rng = np.random.default_rng(seed)
    sc = SceneDef(name="brain")

    def add_point(center, scale, color):
        p = PrimDef(PrimType.POINT, color=np.asarray(color, float))
        p.affine = (tuple(scale), (0, 0, 0, 1), tuple(center))
        p.fwd, p.bwd = compose_trs(center, (0, 0, 0, 1), scale)
        sc.add_prim(p)

    gray = (0.72, 0.62, 0.62, 1.0)
    pink = (0.80, 0.55, 0.55, 1.0)

    # Cortical hemispheres: points along folded bands over an ellipsoid.
    for side in (-1.0, 1.0):
        for band in range(7):
            u = (band + 0.5) / 7 * np.pi  # polar angle
            n_pts = max(6, int(14 * np.sin(u)))
            for k in range(n_pts):
                v = (k + 0.5) / n_pts * np.pi  # front-to-back
                # Ellipsoid radius with gyri ripple.
                ripple = 1.0 + 0.12 * np.sin(6.0 * v + 2.0 * band)
                x = side * (0.25 + 0.95 * np.sin(u) * np.sin(v)) * ripple
                y = 0.85 * np.cos(u) * ripple + 0.25
                z = 1.25 * np.cos(v) * ripple
                jitter = rng.normal(0, 0.02, 3)
                s = 0.55 + 0.1 * np.sin(u) + rng.uniform(-0.05, 0.05)
                add_point(
                    np.array([x, y, z]) + jitter,
                    (s, s * 0.9, s),
                    gray if band % 2 == 0 else pink,
                )

    # Interior fill so the brain is solid, not a hollow shell.
    for side in (-0.45, 0.45):
        for z in (-0.7, 0.0, 0.7):
            add_point(
                np.array([side, 0.25, z]),
                (0.8, 0.7, 0.8),
                (0.78, 0.6, 0.6, 1.0),
            )

    # Cerebellum: smaller, denser cluster behind/below.
    for k in range(24):
        th = 2 * np.pi * k / 24
        r = 0.45 + 0.1 * np.sin(5 * th)
        add_point(
            np.array([0.55 * np.cos(th) * r / 0.5, -0.55 + 0.15 * np.sin(2 * th),
                      -1.15 - 0.25 * np.sin(th) * 0]),
            (0.35, 0.3, 0.35),
            (0.65, 0.5, 0.55, 1.0),
        )

    # Brainstem.
    stem = PrimDef(
        PrimType.CYLINDER,
        pos=np.array([0.0, -0.55, -0.55]),
        dir=np.array([0.0, -1.0, -0.35]) / np.linalg.norm([0, -1.0, -0.35]),
        res=np.array([0.28, 0.9, 0, 0]),
        color=np.array([0.75, 0.65, 0.6, 1.0]),
    )
    stem.affine = ((1, 1, 1), (0, 0, 0, 1), (0, 0, 0))
    sc.add_prim(stem)

    n = len(sc.prims)
    sc.add_op(OpDef(OpType.BLEND, left=0, right=n - 1, is_range=True))
    sc.root_is_op, sc.root_idx = True, 0
    return sc


def main() -> None:
    out_dir = Path(__file__).resolve().parent.parent / "data" / "models"
    (out_dir / "blobtree").mkdir(parents=True, exist_ok=True)
    sc = make_brain()
    blob_path = out_dir / "blobtree" / "brain.blob"
    save_blob(sc, blob_path)
    cfg = SimConfig(
        input_file="blobtree/brain.blob",
        cellsize=0.14,
        gravity=False,
        cam_roll=30.0,
        cam_tilt=70.0,
        cam_zoom=8.0,
        force_coeff=5000.0,
    )
    cfg.save(out_dir / "brain.sim")
    print(f"wrote {blob_path} with {len(sc.prims)} prims")


if __name__ == "__main__":
    main()
