"""Field-evaluation goldens: vectorized JAX evaluator vs the scalar NumPy
oracle (a transliteration of the reference math,
data/opencl/Polygonizer.cl:483-729)."""
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fembrain.assets import MODELS_DIR
from fembrain.blob.reader import load_blob
from fembrain.blob.scene import OpDef, PrimDef, SceneDef
from fembrain.blob.types import OpType, PrimType
from fembrain.ops import field as jfield
from fembrain.ops import field_ref

BLOB_DIR = MODELS_DIR / "blobtree"
ALL_BLOBS = sorted(p.stem for p in BLOB_DIR.glob("*.blob")) if BLOB_DIR.exists() else []


def _sample_points(scene, n=64, seed=0, margin=0.2):
    lo = np.asarray(scene.bbox_lo, np.float64) - margin
    hi = np.asarray(scene.bbox_hi, np.float64) + margin
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ALL_BLOBS)
def test_field_matches_oracle(name):
    sc = load_blob(BLOB_DIR / f"{name}.blob")
    sc.flatten_instances()
    scene = sc.pack()
    # The Python-recursion oracle is slow on instancing stress scenes.
    n = 64 if scene.n_prims <= 256 else 8
    pts = _sample_points(scene, n=n)
    fj = np.asarray(jax.jit(jfield.field)(scene, pts))
    fr = field_ref.field_many(sc, pts)
    # f32 vs f64: tolerance scales mildly with scene size.
    tol = 1e-5 * max(1.0, scene.n_prims / 16)
    np.testing.assert_allclose(fj, fr, atol=tol, rtol=1e-4)


def test_all_blobs_parse():
    assert len(ALL_BLOBS) >= 30
    for name in ALL_BLOBS:
        sc = load_blob(BLOB_DIR / f"{name}.blob")
        assert sc.prims, name


def test_wyvill_kernel():
    # (1 - d^2)^3 with compact support (Polygonizer.cl:278-284).
    d = jnp.array([0.0, 0.5, 1.0, 2.0])
    f = jfield.wyvill(d * d)
    np.testing.assert_allclose(f, [(1 - 0) ** 3, 0.75**3, 0.0, 0.0], atol=1e-7)


def test_gradient_matches_finite_differences():
    """`jax.grad` field gradients vs central differences of the float64
    oracle — the BASELINE 'grad-check max err' metric."""
    sc = load_blob(BLOB_DIR / "tumor.blob")
    scene = sc.pack()
    pts = _sample_points(scene, n=128, seed=1)
    f = np.asarray(jfield.field(scene, pts))
    # Check where the field is smooth and non-degenerate.
    sel = (f > 0.05) & (f < 1.5)
    pts = pts[sel][:32]
    gj = np.asarray(jfield.gradient(scene, pts))
    for i, p in enumerate(pts):
        gr = field_ref.gradient_fd(sc, p, delta=1e-4)
        np.testing.assert_allclose(gj[i], gr, atol=5e-3, rtol=1e-2)


def test_gradient_f64_tight():
    """In float64 the autodiff gradient matches FD to 1e-6."""
    sc = load_blob(BLOB_DIR / "peanut.blob")
    scene = sc.pack()
    pts = _sample_points(scene, n=64, seed=2).astype(np.float64)
    with jax.enable_x64(True):
        f = np.asarray(jfield.field(scene, pts))
        sel = (f > 0.05) & (f < 1.2)
        pts = pts[sel][:16]
        gj = np.asarray(jfield.gradient(scene, pts))
    for i, p in enumerate(pts):
        gr = field_ref.gradient_fd(sc, p, delta=1e-5)
        assert np.abs(gj[i] - gr).max() < 1e-5


def test_normal_is_unit():
    sc = load_blob(BLOB_DIR / "sphere.blob")
    scene = sc.pack()
    pts = np.array([[0.3, 0.1, 0.0], [0.0, 0.35, 0.1]], np.float32)
    n = np.asarray(jfield.normal(scene, pts))
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-5)
    # Sphere at origin: outward normal is the radial direction.
    rad = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    np.testing.assert_allclose(n, rad, atol=1e-4)


def _warped_scene(wtype: OpType, params) -> SceneDef:
    sc = SceneDef()
    p = PrimDef(PrimType.LINE, pos=np.array([-0.5, 0, 0.0]), dir=np.array([0.5, 0, 0.0]))
    sc.add_prim(p)
    op = OpDef(wtype, left=0, is_unary=True, params=np.asarray(params, np.float64))
    sc.add_op(op)
    sc.root_is_op, sc.root_idx = True, 0
    return sc


@pytest.mark.parametrize(
    "wtype,params",
    [
        (OpType.WARP_TWIST, [0.8, 0, 0, 0]),
        (OpType.WARP_SHEAR, [0.5, 0, 2, 0]),
        (OpType.WARP_TAPER, [0.4, 0, 2, 0]),
        (OpType.WARP_BEND, [0.6, 0.0, -0.5, 0.5]),
    ],
)
def test_warp_ops_match_oracle(wtype, params):
    """Warp chains (JAX) vs recursive warp eval (oracle)."""
    sc = _warped_scene(wtype, params)
    scene = sc.pack()
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.2, 1.2, size=(64, 3)).astype(np.float32)
    fj = np.asarray(jax.jit(jfield.field)(scene, pts))
    fr = field_ref.field_many(sc, pts)
    np.testing.assert_allclose(fj, fr, atol=2e-5)


def test_instance_flattening_matches_manual_compose():
    """An instance of a prim equals the prim with composed transform."""
    sc = load_blob(BLOB_DIR / "peanutInstanced.blob")
    sc2 = load_blob(BLOB_DIR / "peanutInstanced.blob")
    sc.flatten_instances()
    scene = sc.pack()
    assert all(p.ptype != PrimType.INSTANCE for p in sc.prims)
    pts = _sample_points(scene, n=32)
    fj = np.asarray(jfield.field(scene, pts))
    fr = field_ref.field_many(sc, pts)
    np.testing.assert_allclose(fj, fr, atol=1e-5)


def test_field_and_color_shapes():
    sc = load_blob(BLOB_DIR / "tumor.blob")
    scene = sc.pack()
    pts = _sample_points(scene, n=16)
    f, c = jfield.field_and_color(scene, pts)
    assert f.shape == (16,)
    assert c.shape == (16, 4)
    assert bool(jnp.all(c >= 0))


def test_field_via_strategies_agree():
    """FieldComputer-analog API: unrolled (stackless-route analog) and
    scan (runtime-stack analog) folds agree on a canned op scene
    (reference FieldComputer.cpp:253-330 kernel comparison)."""
    import numpy as np

    from fembrain.ops.field import field, field_via

    sc = load_blob(BLOB_DIR / "tumor.blob")
    sc.flatten_instances()
    scene = sc.pack()
    pts = np.random.default_rng(3).uniform(-2, 2, (256, 3)).astype(np.float32)
    f_auto = np.asarray(field(scene, pts))
    f_unrl = np.asarray(field_via(scene, pts, "unrolled"))
    f_scan = np.asarray(field_via(scene, pts, "scan"))
    np.testing.assert_allclose(f_unrl, f_auto, rtol=0, atol=0)
    np.testing.assert_allclose(f_scan, f_auto, rtol=1e-6, atol=1e-6)
