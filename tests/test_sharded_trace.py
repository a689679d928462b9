"""Sharded production tracer: trace_pallas under shard_map must equal the
single-device kernel bit-for-bit (VERDICT r2 #2 — the distribution layer
has to carry the kernel that holds the perf numbers, not the XLA tracer).
Runs on the 8-virtual-device CPU mesh in interpret mode."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fembrain.assets import blob_path
from fembrain.blob.reader import load_blob
from fembrain.parallel import sharding as sh
from fembrain.render.camera import Camera, generate_rays
from fembrain.render.pallas_trace import (
    trace_pallas,
    trace_pallas_image,
    trace_pallas_image_sharded,
    trace_pallas_sharded,
)

TILE = 256  # small tile so 8 shards see several tiles each


def _rays(zoom=7.0, w=40, h=26):
    cam = Camera.orbit(25, 20, zoom)
    ro, rd = generate_rays(cam, w, h)
    return ro.reshape(-1, 3), rd.reshape(-1, 3)


def test_sharded_matches_single_device():
    scene = load_blob(blob_path("tumor")).pack()
    ro, rd = _rays()
    mesh = sh.make_mesh(8)
    t1, h1 = trace_pallas(scene, ro, rd, interpret=True, tile=TILE)
    t2, h2 = jax.jit(
        lambda s, o, d: trace_pallas_sharded(
            s, o, d, mesh, interpret=True, tile=TILE
        )
    )(scene, ro, rd)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=0,
                               atol=0)


def test_sharded_image_matches_single_device():
    scene = load_blob(blob_path("tumor")).pack()
    h, w = 24, 40
    ro, rd = _rays(7.0, w, h)
    mesh = sh.make_mesh(8)
    t1, h1 = trace_pallas_image(scene, ro, rd, h, w, interpret=True,
                                tile=TILE)
    t2, h2 = trace_pallas_image_sharded(scene, ro, rd, h, w, mesh,
                                        interpret=True, tile=TILE)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=0,
                               atol=0)


def test_sharded_host_chip_mesh():
    """Rays shard jointly over the 2-D ('host','chip') mesh — the
    multi-host code path of SURVEY §5.8."""
    scene = load_blob(blob_path("sphere")).pack()
    ro, rd = _rays(2.0)
    hc = sh.make_host_chip_mesh(2, 4)
    t1, h1 = trace_pallas(scene, ro, rd, interpret=True, tile=TILE)
    t2, h2 = trace_pallas_sharded(scene, ro, rd, hc, interpret=True,
                                  tile=TILE)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=0,
                               atol=0)


def test_sharded_deformed_disp_matches():
    """The deformed (Wendland displacement) kernel path shards
    identically: disp spec replicated, rays split."""
    from fembrain.render.deformed import (
        build_disp_interp,
        disp_weights,
        wendland_pallas_spec,
    )

    scene = load_blob(blob_path("sphere")).pack()
    ro, rd = _rays(2.0, 32, 16)
    rng = np.random.default_rng(0)
    nodes = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    interp = build_disp_interp(nodes, n_centers=64, kernel="wendland")
    q = jnp.asarray(
        0.02 * np.sin(nodes * 3.0), jnp.float32
    )
    disp = wendland_pallas_spec(interp, disp_weights(interp, q))
    mesh = sh.make_mesh(8)
    t1, h1 = trace_pallas(scene, ro, rd, interpret=True, tile=TILE,
                          disp=disp)
    t2, h2 = trace_pallas_sharded(scene, ro, rd, mesh, interpret=True,
                                  tile=TILE, disp=disp)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=0,
                               atol=0)
