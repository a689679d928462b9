"""Checkpoint / resume for simulation state.

The reference persists settings (.sim round-trip, main.cpp:508-611) and
mesh snapshots (.veg export) but has no mid-simulation state serialization
(SURVEY §5.4); this adds proper pytree checkpointing: any pytree of arrays
(FemState, Scene, camera, frame counters) round-trips through a single
.npz file. The XLA compilation cache plays the role of the reference's
PTX kernel cache (ComputeDevice.h:251-260).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

import jax


def save_pytree(path: str | Path, tree) -> None:
    """Serialize a pytree of arrays/scalars to .npz + structure JSON."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    arrays = {}
    meta = []
    for i, leaf in enumerate(leaves):
        arr = np.asarray(leaf)
        arrays[f"leaf_{i}"] = arr
        meta.append({"dtype": str(arr.dtype), "shape": list(arr.shape)})
    path = Path(path)
    np.savez_compressed(
        path,
        __treedef__=np.frombuffer(
            json.dumps({"n": len(leaves), "meta": meta}).encode(), np.uint8
        ),
        **arrays,
    )


def load_pytree(path: str | Path, like):
    """Load arrays saved by save_pytree into the structure of `like`."""
    p = Path(path)
    if not p.exists() and p.with_suffix(p.suffix + ".npz").exists():
        p = p.with_suffix(p.suffix + ".npz")
    data = np.load(p, allow_pickle=False)
    leaves_like, treedef = jax.tree_util.tree_flatten(like)
    n = len(leaves_like)
    leaves = []
    for i in range(n):
        arr = data[f"leaf_{i}"]
        ref = leaves_like[i]
        if hasattr(ref, "dtype"):
            import jax.numpy as jnp

            leaves.append(jnp.asarray(arr, getattr(ref, "dtype", None)))
        else:
            leaves.append(type(ref)(arr))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def enable_compilation_cache() -> str:
    """Persistent XLA compilation cache (the reference caches compiled CL
    programs as .ptx keyed by source MD5; XLA's cache is the analog).

    Honors JAX_COMPILATION_CACHE_DIR when it is set and sets no other
    directory then; otherwise the cache is the fixed .jax_cache/ in the
    checkout (a fixed path: the path is part of the cache key). Returns
    the directory in use."""
    import os

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(Path(__file__).resolve().parents[2] / ".jax_cache")
        Path(path).mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
