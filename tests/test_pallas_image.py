"""Block-coherent image tracing (trace_pallas_image) vs the XLA tracer."""
import numpy as np
import pytest

import jax.numpy as jnp

from fembrain.assets import blob_path
from fembrain.blob.reader import load_blob
from fembrain.render.camera import Camera, generate_rays
from fembrain.render.pallas_trace import (
    _block_layout,
    block_permutation,
    block_shape,
    trace_pallas_image,
)
from fembrain.render.sphere_trace import trace


def test_block_permutation_is_bijective():
    perm = block_permutation(50, 70, bh=8, bw=16)
    live = perm[perm >= 0]
    assert len(live) == 50 * 70
    assert len(np.unique(live)) == 50 * 70
    assert perm.size % (8 * 16) == 0


def test_blocked_image_matches_xla():
    scene = load_blob(blob_path("tumor")).pack()
    cam = Camera.orbit(25, 20, 7.0)
    w, h = 36, 20
    ro, rd = generate_rays(cam, w, h)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    t1, h1 = trace(scene, ro, rd)
    t2, h2 = trace_pallas_image(scene, ro, rd, h, w, interpret=True)
    h1, h2 = np.asarray(h1), np.asarray(h2)
    assert (h1 != h2).sum() <= 2  # grazing-edge rays may flip
    m = h1 & h2
    assert np.abs(np.asarray(t1)[m] - np.asarray(t2)[m]).max() < 1e-4


@pytest.mark.parametrize("tile", [128, 256, 512])
def test_block_layout_matches_permutation(tile):
    """The pad + transpose layout puts rays in block_permutation's order,
    with near-square blocks of exactly one tile, and inverts exactly."""
    bh, bw = block_shape(tile)
    assert bh * bw == tile and bw in (bh, 2 * bh)
    h, w = 21, 37
    to_blocks, from_blocks, (ph, pw), n = _block_layout(h, w, tile)
    assert n % tile == 0 and (h + ph) % bh == 0 and (w + pw) % bw == 0
    idx = np.arange(h * w, dtype=np.float32)
    rows = jnp.stack([jnp.asarray(idx)] * 3, -1)
    blocked = np.asarray(to_blocks(rows, -1.0))[:, 0]
    perm = block_permutation(h, w, bh, bw)
    np.testing.assert_array_equal(blocked, np.where(perm >= 0, perm, -1))
    np.testing.assert_array_equal(
        np.asarray(from_blocks(jnp.asarray(blocked))), idx
    )
