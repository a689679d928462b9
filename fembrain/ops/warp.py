"""Coordinate-warp operators (twist / taper / bend / shear).

The reference declares these operators (data/opencl/Polygonizer.cl:139-143,
parsed in src/implicit/ReadSceneModel.cpp:373-425) but evaluates them as
pass-through stubs (src/implicit/Polygonizer.cpp:2048-2063). Here they are
implemented properly as Barr-style space deformations: evaluating a warped
subtree at point ``v`` evaluates the subtree at ``warp_point(v)``, the
*inverse* deformation applied to the query point.

Two entry points, ONE math implementation:
  * ``warp_components`` — component (SoA) form on (x, y, z) planes of any
    broadcastable shape, with scalar parameters, so it lowers inside the
    Pallas trace kernel — this is what puts BASELINE config #2
    (blend + warp) on the kernel fast path.
  * ``warp_point`` — [..., 3] stacked wrapper used by the XLA evaluator
    and (via np.asarray) the NumPy test oracle.

Parameter layout (from the `.blob` parser, ReadSceneModel.cpp:373-425):
  twist:  params = (factor, axis, -, -)
  taper:  params = (factor, base_axis, taper_axis, -)
  bend:   params = (rate, center, left_bound, right_bound)
  shear:  params = (factor, base_axis, shear_axis, -)
Axis parameters are static (scene wiring), values 0/1/2 = x/y/z.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..blob.types import OpType


def _axes_for(axis: int) -> tuple[int, int]:
    """The two axes orthogonal to `axis`, in right-handed order."""
    return ((1, 2), (2, 0), (0, 1))[axis]


def warp_components(wtype: int, p, axis_a: int, axis_b: int, x, y, z):
    """Apply the inverse deformation of one warp op to component planes.

    x/y/z: coordinate arrays of any (matching/broadcastable) shape;
    p: 4-tuple of broadcastable scalar parameters; wtype/axis_* static.
    Returns the warped (x, y, z) tuple.
    """
    wtype = int(wtype)
    comps = [x, y, z]
    if wtype == int(OpType.WARP_TWIST):
        a, b = _axes_for(axis_a)
        ang = -p[0] * comps[axis_a]
        c, s = jnp.cos(ang), jnp.sin(ang)
        va, vb = comps[a], comps[b]
        comps[a] = c * va - s * vb
        comps[b] = s * va + c * vb
    elif wtype == int(OpType.WARP_TAPER):
        s = 1.0 + p[0] * comps[axis_a]
        safe = jnp.where(
            jnp.abs(s) < 1e-6, jnp.sign(s) * 1e-6 + (s == 0) * 1e-6, s
        )
        comps[axis_b] = comps[axis_b] / safe
    elif wtype == int(OpType.WARP_BEND):
        k, center, lbound, rbound = p
        xx, yy = comps[0], comps[1]
        kk = jnp.where(jnp.abs(k) < 1e-8, 1e-8, k)
        # Center of curvature of the forward bend.
        cy = 1.0 / kk
        xc = jnp.clip(xx, lbound, rbound)
        # Inverse rotation angle about the curvature center.
        theta = -kk * (xc - center)
        c, s = jnp.cos(theta), jnp.sin(theta)
        xr = c * (xx - center) - s * (yy - cy)
        yr = s * (xx - center) + c * (yy - cy)
        x2 = xr + center
        y2 = yr + cy
        # Outside the bend region the map is a rigid continuation; the
        # clamped rotation above reduces to identity at theta(l/rbound).
        small = jnp.abs(k) < 1e-8
        comps[0] = jnp.where(small, xx, x2)
        comps[1] = jnp.where(small, yy, y2)
    elif wtype == int(OpType.WARP_SHEAR):
        comps[axis_b] = comps[axis_b] - p[0] * comps[axis_a]
    return tuple(comps)


def warp_point(wtype: int, params, axis_a: int, axis_b: int, v):
    """Apply the inverse deformation of one warp op to query point(s).

    v: [..., 3]; params: traced f32[4]; wtype/axis_* static ints."""
    p = tuple(params[i] for i in range(4))
    x, y, z = warp_components(
        wtype, p, axis_a, axis_b, v[..., 0], v[..., 1], v[..., 2]
    )
    return jnp.stack([x, y, z], axis=-1)
