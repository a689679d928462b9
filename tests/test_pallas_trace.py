"""Sphere-trace kernel vs the XLA tracer (interpret mode on CPU), and the
wrapper around it: padding, tile sizes, path selection."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fembrain.assets import blob_path, load_scene
from fembrain.blob.reader import load_blob
from fembrain.ops.field import supports_rows_fast_path
from fembrain.render.camera import Camera, generate_rays
from fembrain.render.pallas_trace import (
    select_trace_path,
    trace_fast,
    trace_pallas,
    zero_cotangent,
)
from fembrain.render.sphere_trace import trace


@pytest.mark.parametrize("name,zoom", [("sphere", 2.0), ("tumor", 7.0),
                                       ("spheredif", 3.0)])
def test_pallas_matches_xla(name, zoom):
    scene = load_blob(blob_path(name)).pack()
    assert supports_rows_fast_path(scene)
    cam = Camera.orbit(25, 20, zoom)
    ro, rd = generate_rays(cam, 40, 26)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    t1, h1 = trace(scene, ro, rd)
    t2, h2 = trace_pallas(scene, ro, rd, interpret=True)
    h1, h2 = np.asarray(h1), np.asarray(h2)
    assert (h1 == h2).mean() > 0.999
    m = h1 & h2
    assert np.abs(np.asarray(t1)[m] - np.asarray(t2)[m]).max() < 1e-4


def test_dif_scene_uses_fixed_steps():
    """Non-monotone ops (DIFFERENCE) disable the adaptive bound."""
    scene = load_blob(blob_path("spheredif")).pack()
    assert not scene.monotone_field
    scene2 = load_blob(blob_path("tumor")).pack()
    assert scene2.monotone_field


def test_trace_fast_gradients_match():
    """trace_fast (pallas forward) carries the same implicit-diff gradient
    as the XLA path."""
    import dataclasses

    import jax

    scene = load_blob(blob_path("sphere")).pack()
    cam = Camera.orbit(10, 10, 2.0)
    ro, rd = generate_rays(cam, 16, 16)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)

    def loss_fast(pos):
        s = dataclasses.replace(scene, prim_pos=pos)
        t, h = trace_fast(s, ro, rd, interpret=True)
        return jnp.sum(jnp.where(h, t, 0.0))

    def loss_xla(pos):
        s = dataclasses.replace(scene, prim_pos=pos)
        t, h = trace(s, ro, rd)
        return jnp.sum(jnp.where(h, t, 0.0))

    g1 = np.asarray(jax.grad(loss_fast)(scene.prim_pos))
    g2 = np.asarray(jax.grad(loss_xla)(scene.prim_pos))
    np.testing.assert_allclose(g1, g2, rtol=1e-3, atol=1e-5)


def test_is_additive_detection():
    """Blobby scenes (root BLEND over all prims) are additive; DIF scenes
    are not."""
    assert load_blob(blob_path("tumor")).pack().is_additive
    assert load_blob(blob_path("brain")).pack().is_additive
    assert not load_blob(blob_path("spheredif")).pack().is_additive


def test_additive_culled_path_matches_xla_brain():
    """The Morton-sorted, block-culled additive kernel path must agree
    with the XLA tracer on the many-prim brain scene (the scene the
    culling exists for)."""
    scene = load_scene("brain")
    assert scene.is_additive
    cam = Camera.orbit(30, 20, 8.0)
    ro, rd = generate_rays(cam, 32, 20)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    t1, h1 = trace(scene, ro, rd)
    t2, h2 = trace_pallas(scene, ro, rd, interpret=True)
    h1, h2 = np.asarray(h1), np.asarray(h2)
    assert (h1 == h2).mean() > 0.999
    m = h1 & h2
    if m.any():
        assert np.abs(np.asarray(t1)[m] - np.asarray(t2)[m]).max() < 1e-4


def test_warp_scene_on_kernel_fast_path():
    """Blend+warp scenes (BASELINE config #2) now run in the kernel:
    supports_rows_fast_path is true and the Pallas trace matches the XLA
    tracer (warp math shared via ops.warp.warp_components)."""
    from fembrain.blob.scene import OpDef, PrimDef, SceneDef
    from fembrain.blob.types import OpType, PrimType

    sc = SceneDef()
    sc.add_prim(PrimDef(PrimType.POINT, pos=np.array([-0.4, 0.0, 0.0])))
    sc.add_prim(PrimDef(PrimType.POINT, pos=np.array([0.4, 0.0, 0.0])))
    blend = sc.add_op(OpDef(OpType.BLEND, left=0, right=1))
    twist = sc.add_op(
        OpDef(OpType.WARP_TWIST, left=blend, left_is_op=True, is_unary=True,
              params=np.array([0.9, 0.0, 0.0, 0.0]))
    )
    sc.root_is_op, sc.root_idx = True, twist
    scene = sc.pack()
    assert len(scene.warp_groups[0][0]) == 1  # prims carry a warp chain
    assert supports_rows_fast_path(scene)
    assert not scene.is_additive  # warps forbid the additive cull path

    cam = Camera.orbit(25, 20, 2.5)
    ro, rd = generate_rays(cam, 40, 26)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    t1, h1 = trace(scene, ro, rd)
    t2, h2 = trace_pallas(scene, ro, rd, interpret=True)
    h1, h2 = np.asarray(h1), np.asarray(h2)
    assert h1.sum() > 20
    assert (h1 == h2).mean() > 0.999
    m = h1 & h2
    assert np.abs(np.asarray(t1)[m] - np.asarray(t2)[m]).max() < 1e-4


def _rays(zoom, w=40, h=26):
    ro, rd = generate_rays(Camera.orbit(25, 20, zoom), w, h)
    return ro.reshape(-1, 3), rd.reshape(-1, 3)


@pytest.mark.parametrize("tile", [128, 256, 512])
def test_tile_sizes_and_padding_agree(tile):
    """Any power-of-two tile gives the same per-ray march (tiles only
    change which rays share an early exit); the ray count (37 x 23) is
    not a multiple of any tile, so the padded tail is exercised."""
    scene = load_scene("tumor")
    ro, rd = _rays(7.0, 37, 23)
    t1, h1 = trace(scene, ro, rd)
    t2, h2 = trace_pallas(scene, ro, rd, interpret=True, tile=tile)
    assert t2.shape == (37 * 23,) and h2.dtype == jnp.bool_
    h1, h2 = np.asarray(h1), np.asarray(h2)
    assert (h1 == h2).mean() > 0.999
    m = h1 & h2
    assert np.abs(np.asarray(t1)[m] - np.asarray(t2)[m]).max() < 1e-4


def test_tile_must_be_power_of_two():
    scene = load_scene("sphere")
    ro, rd = _rays(2.0, 8, 8)
    with pytest.raises(ValueError, match="power of two"):
        trace_pallas(scene, ro, rd, interpret=True, tile=96)


def test_select_trace_path():
    """One choice of tracer: XLA on the CPU, the kernel when a test asks
    for interpret mode, and the XLA tracer for anything the kernel does
    not cover, whatever the platform."""
    tumor, dif = load_scene("tumor"), load_scene("spheredif")
    assert jax.default_backend() == "cpu"
    p = select_trace_path(tumor)
    assert not p.kernel and "cpu" in p.reason
    p = select_trace_path(tumor, interpret=True)
    assert p.kernel and p.interpret
    # Non-additive scenes: the generic kernel for rest traces only.
    assert select_trace_path(dif, interpret=True).kernel
    p = select_trace_path(dif, deformed="wendland", interpret=True)
    assert not p.kernel and "scene" in p.reason
    # The kernel traces no biharmonic interpolant.
    p = select_trace_path(tumor, deformed="biharmonic", interpret=True)
    assert not p.kernel and "biharmonic" in p.reason
    assert select_trace_path(tumor, deformed="wendland",
                             interpret=True).kernel


def test_trace_fast_off_kernel_is_the_xla_tracer():
    """On the CPU without interpret mode trace_fast is the XLA tracer."""
    scene = load_scene("sphere")
    ro, rd = _rays(2.0, 12, 10)
    t1, h1 = trace(scene, ro, rd)
    t2, h2 = trace_fast(scene, ro, rd)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))


def test_zero_cotangent_vjp():
    """The forward-only kernel's VJP: every input gets a zero cotangent
    (integer leaves a float0 one), so gradients come only from the
    implicit-hit correction."""
    scene = load_scene("sphere")
    ro, rd = _rays(2.0, 8, 8)
    raw = zero_cotangent(
        lambda s, o, d: trace_pallas(s, o, d, interpret=True)
    )

    def loss(pos, o):
        import dataclasses

        t, hit = raw(dataclasses.replace(scene, prim_pos=pos), o, rd)
        return jnp.sum(jnp.where(hit, t, 0.0))

    g_pos, g_ro = jax.grad(loss, argnums=(0, 1))(scene.prim_pos, ro)
    assert not np.asarray(g_pos).any() and not np.asarray(g_ro).any()
    assert float(loss(scene.prim_pos, ro)) > 0.0
