"""Multi-host layer (SURVEY §5.8 / VERDICT r1 item 6): ('host','chip')
mesh construction, the jax.distributed entry point, and the grad
all-reduce in the compiled train step.

Real DCN needs a real pod; these tests pin the CODE PATH on the 8-device
CPU-sim mesh (conftest) — the same functions run unchanged multi-host.
"""
import numpy as np

import jax
import jax.numpy as jnp

from fembrain.assets import MODELS_DIR
from fembrain.blob.reader import load_blob
from fembrain.parallel import sharding as sh
from fembrain.render.camera import Camera, generate_rays

SPHERE = str(MODELS_DIR / "blobtree" / "sphere.blob")


def _rays(n=64):
    cam = Camera.orbit(15, 10, 2.0)
    ro, rd = generate_rays(cam, 8, n // 8)
    return ro.reshape(-1, 3), rd.reshape(-1, 3)


def test_initialize_distributed_single_process_noop():
    # Single process: no coordinator needed, returns global device count.
    assert sh.initialize_distributed() == len(jax.devices())


def test_host_chip_mesh_axes():
    mesh = sh.make_host_chip_mesh(2, 4)
    assert mesh.axis_names == (sh.HOST_AXIS, sh.CHIP_AXIS)
    assert mesh.devices.shape == (2, 4)


def test_train_step_on_host_chip_mesh():
    """The differentiable-render train step runs on the 2-D mesh with
    rays sharded over (host, chip) jointly and the scene replicated."""
    scene = load_blob(SPHERE).pack()
    mesh = sh.make_host_chip_mesh(2, 4)
    ro, rd = _rays(64)
    target = jnp.zeros(ro.shape[0])
    scene_d = sh.replicate(mesh, scene)
    ro_d, rd_d, tg_d = sh.shard_rays(mesh, ro, rd, target)
    step = jax.jit(sh.make_train_step(lr=1e-3))
    new_scene, loss = step(scene_d, ro_d, rd_d, tg_d)
    assert np.isfinite(float(loss))
    # Scene grads applied identically on every device (replicated).
    assert not np.allclose(
        np.asarray(new_scene.prim_pos), np.asarray(scene.prim_pos)
    )


def test_grad_allreduce_in_compiled_step():
    """The compiled train step must contain the cross-device grad
    reduction (XLA-inserted all-reduce). The scene is <= ~100 KB, so the
    transfer is a single fused all-reduce."""
    scene = load_blob(SPHERE).pack()
    mesh = sh.make_host_chip_mesh(2, 4)
    ro, rd = _rays(64)
    target = jnp.zeros(ro.shape[0])
    scene_d = sh.replicate(mesh, scene)
    ro_d, rd_d, tg_d = sh.shard_rays(mesh, ro, rd, target)
    step = jax.jit(sh.make_train_step(lr=1e-3))
    txt = step.lower(scene_d, ro_d, rd_d, tg_d).compile().as_text()
    assert "all-reduce" in txt, "no cross-device grad reduction found"
