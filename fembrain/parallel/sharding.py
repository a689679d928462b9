"""Device-mesh sharding for rendering and simulation.

The reference is strictly single-process/single-GPU (SURVEY §2.6 P7); this
module is the new distributed layer: a `jax.sharding.Mesh` over all chips,
rays/pixels sharded along a `rays` axis, the BlobTree scene replicated
(<= ~100 KB — never shard the scene), and parameter gradients all-reduced
by XLA-inserted collectives over ICI. Tetrahedra shard along a `tets` axis
for FEM (see fem.*), with shared-node forces combined by segment-sum after
an all-gather of the small per-partition boundary sets.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAY_AXIS = "rays"
HOST_AXIS = "host"
CHIP_AXIS = "chip"


def make_mesh(n_devices: int | None = None, axis: str = RAY_AXIS) -> Mesh:
    """1-D mesh over the first n devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> int:
    """Multi-host entry point (SURVEY §5.8): on a real multi-host slice
    call this once per process before any JAX op — it wires the JAX
    runtime so jax.devices() spans every host (DCN between hosts, ICI
    within). Single-process (or CPU-sim) callers get a no-op. Returns
    the global device count."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return len(jax.devices())


def make_host_chip_mesh(n_hosts: int | None = None,
                        chips_per_host: int | None = None) -> Mesh:
    """2-D ('host', 'chip') mesh. Across hosts the host axis rides the
    network between hosts and the chip axis NVLink within a host, so
    shardings that reduce along 'chip' first keep the slow axis cold.
    Locally (or on the CPU-sim mesh) the same axes partition
    jax.devices() — a simulated N-host split. Device order: jax.devices()
    is grouped by process, so reshaping (hosts, chips) aligns rows with
    real hosts."""
    devs = np.array(jax.devices())
    if n_hosts is None:
        n_hosts = max(1, jax.process_count())
    if chips_per_host is None:
        chips_per_host = len(devs) // n_hosts
    devs = devs[: n_hosts * chips_per_host]
    return Mesh(devs.reshape(n_hosts, chips_per_host),
                (HOST_AXIS, CHIP_AXIS))


def shard_rays(mesh: Mesh, *arrays):
    """Place ray-batch arrays row-sharded over the mesh (1-D `rays` axis
    or a 2-D ('host','chip') mesh — rays split over both axes jointly)."""
    if HOST_AXIS in mesh.axis_names:
        sh = NamedSharding(mesh, P((HOST_AXIS, CHIP_AXIS)))
    else:
        sh = NamedSharding(mesh, P(RAY_AXIS))
    return tuple(jax.device_put(a, sh) for a in arrays)


def replicate(mesh: Mesh, tree):
    """Replicate a pytree (the scene / camera) on every device."""
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), tree)


def pad_to_multiple(arr: jax.Array, multiple: int, axis: int = 0):
    """Pad axis 0 so it divides the mesh size; returns (padded, true_n)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rem)
    return jnp.pad(arr, pad), n


def render_loss(scene, ro, rd, target):
    """Mean depth-difference loss over a sharded ray batch.

    With ro/rd/target sharded over `rays` and the scene replicated, XLA
    inserts the cross-chip reduction for the mean and a gradient psum for
    the (replicated) scene parameters automatically.
    """
    from ..render.sphere_trace import trace

    t, hit = trace(scene, ro, rd)
    d = jnp.where(hit, t, 0.0)
    return jnp.mean((d - target) ** 2)


def make_train_step(lr: float = 1e-2):
    """Differentiable-render training step: grads flow to every float
    scene parameter (primitive transforms/positions/params/colors and
    operator params)."""

    def train_step(scene, ro, rd, target):
        def loss_fn(diff_scene):
            return render_loss(diff_scene, ro, rd, target)

        # allow_int: integer wiring leaves get float0 gradients we ignore.
        loss, grads = jax.value_and_grad(loss_fn, allow_int=True)(scene)

        def upd(p, g):
            if (
                g is None
                or g.dtype == jax.dtypes.float0
                or not jnp.issubdtype(p.dtype, jnp.floating)
            ):
                return p
            return p - lr * g

        new_scene = jax.tree_util.tree_map(upd, scene, grads)
        return new_scene, loss

    return train_step
