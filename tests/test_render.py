"""Sphere-tracer tests: analytic geometry, hit accuracy against the field
oracle, and pixel-gradient checks vs finite differences (BASELINE configs
#1 and #2)."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fembrain.assets import MODELS_DIR
from fembrain.blob.reader import load_blob
from fembrain.blob.scene import OpDef, PrimDef, SceneDef
from fembrain.blob.types import OpType, PrimType
from fembrain.ops import field_ref
from fembrain.render.camera import Camera, generate_rays
from fembrain.render.sphere_trace import (
    TraceParams,
    depth_image,
    render_image,
    trace,
)

BLOB_DIR = MODELS_DIR / "blobtree"
R_SPHERE = float(np.sqrt(1 - 0.5 ** (1 / 3)))  # field (1-r^2)^3 = 0.5


@pytest.fixture(scope="module")
def sphere_scene():
    return load_blob(BLOB_DIR / "sphere.blob").pack()


def test_sphere_center_depth(sphere_scene):
    cam = Camera.orbit(0, 0, 2.0)
    t, hit = depth_image(sphere_scene, cam, 65, 65)
    assert bool(hit[32, 32])
    assert abs(float(t[32, 32]) - (2.0 - R_SPHERE)) < 1e-3


def test_sphere_silhouette(sphere_scene):
    cam = Camera.orbit(40, 25, 2.0)
    t, hit = depth_image(sphere_scene, cam, 64, 64)
    hit = np.asarray(hit)
    # Roughly circular silhouette centered in frame.
    frac = hit.mean()
    assert 0.15 < frac < 0.45
    ys, xs = np.where(hit)
    assert abs(xs.mean() - 31.5) < 2 and abs(ys.mean() - 31.5) < 2


def test_hit_points_lie_on_iso_surface(sphere_scene):
    """Hit positions satisfy field = 0.5 per the NumPy oracle."""
    sc = load_blob(BLOB_DIR / "tumor.blob")
    scene = sc.pack()
    cam = Camera.orbit(30, 30, 6.0)
    ro, rd = generate_rays(cam, 32, 32)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    t, hit = trace(scene, ro, rd)
    x = np.asarray(ro + t[:, None] * rd)[np.asarray(hit)]
    f = field_ref.field_many(sc, x[:64])
    np.testing.assert_allclose(f, 0.5, atol=2e-3)


def test_render_image_shapes(sphere_scene):
    cam = Camera.orbit(30, 20, 2.0)
    img = render_image(sphere_scene, cam, 48, 32)
    assert img.shape == (32, 48, 3)
    img = np.asarray(img)
    assert np.isfinite(img).all()


def test_pixel_gradients_vs_finite_differences(sphere_scene):
    """d(mean depth)/d(prim position) by autodiff == finite differences.

    This is the BASELINE 'pixel gradients allclose vs finite differences'
    check on config #1 (single point primitive)."""
    cam = Camera.orbit(15, 10, 2.0)
    ro, rd = generate_rays(cam, 24, 24)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    scene = sphere_scene

    def loss(prim_pos):
        s = dataclasses.replace(scene, prim_pos=prim_pos)
        t, hit = trace(s, ro, rd)
        return jnp.sum(jnp.where(hit, t, 0.0))

    g = np.asarray(jax.grad(loss)(scene.prim_pos))[0]
    eps = 1e-3
    g_fd = np.zeros(3)
    base = np.asarray(scene.prim_pos)
    for k in range(3):
        dp = base.copy()
        dp[0, k] += eps
        dm = base.copy()
        dm[0, k] -= eps
        g_fd[k] = (loss(jnp.asarray(dp)) - loss(jnp.asarray(dm))) / (2 * eps)
    assert np.abs(g).max() > 1e-3  # non-degenerate
    np.testing.assert_allclose(g, g_fd, rtol=0.05, atol=5e-3)


def _blend_warp_scene():
    """BASELINE config #2: two-primitive blend with a twist warp."""
    sc = SceneDef()
    sc.add_prim(PrimDef(PrimType.POINT, pos=np.array([-0.35, 0, 0.0]),
                        color=np.array([1, 0, 0, 1.0])))
    sc.add_prim(PrimDef(PrimType.POINT, pos=np.array([0.35, 0, 0.0]),
                        color=np.array([0, 0, 1, 1.0])))
    blend = OpDef(OpType.BLEND, left=0, right=1)
    i_blend = sc.add_op(blend)
    twist = OpDef(OpType.WARP_TWIST, left=i_blend, left_is_op=True,
                  is_unary=True, params=np.array([0.7, 1.0, 0, 0]))
    i_twist = sc.add_op(twist)
    sc.root_is_op, sc.root_idx = True, i_twist
    return sc


def test_blend_warp_render_and_grad():
    sc = _blend_warp_scene()
    scene = sc.pack()
    cam = Camera.orbit(20, 15, 2.2)
    ro, rd = generate_rays(cam, 24, 24)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    t, hit = trace(scene, ro, rd)
    assert 0.05 < float(jnp.mean(hit.astype(jnp.float32))) < 0.9
    # Hits satisfy the oracle field (warped, blended).
    x = np.asarray(ro + t[:, None] * rd)[np.asarray(hit)]
    f = field_ref.field_many(sc, x[:32])
    np.testing.assert_allclose(f, 0.5, atol=2e-3)

    # Gradient w.r.t. the twist factor (op params) via the renderer.
    def loss(op_params):
        s = dataclasses.replace(scene, op_params=op_params)
        tt, hh = trace(s, ro, rd)
        return jnp.sum(jnp.where(hh, tt, 0.0))

    g = np.asarray(jax.grad(loss)(scene.op_params))
    eps = 1e-3
    p_plus = np.asarray(scene.op_params).copy()
    p_plus[1, 0] += eps
    p_minus = np.asarray(scene.op_params).copy()
    p_minus[1, 0] -= eps
    fd = (loss(jnp.asarray(p_plus)) - loss(jnp.asarray(p_minus))) / (2 * eps)
    assert abs(g[1, 0] - fd) < 0.05 * max(1.0, abs(fd))
