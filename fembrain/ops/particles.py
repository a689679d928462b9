"""Particle system demo (reference `Particles` + ParticleSystem.cl:1-46):
position/velocity integration with gravity and box bounce, as one jitted
step over particle arrays — the vectorized analog of the reference's
per-particle OpenCL kernels."""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ParticleState:
    pos: jax.Array   # [N, 3]
    vel: jax.Array   # [N, 3]
    age: jax.Array   # [N]


def init_particles(n: int, seed: int = 0, box=1.0) -> ParticleState:
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return ParticleState(
        pos=jax.random.uniform(k1, (n, 3), minval=-box, maxval=box),
        vel=jax.random.normal(k2, (n, 3)) * 0.1,
        age=jnp.zeros(n),
    )


@partial(jax.jit, static_argnames=())
def step_particles(state: ParticleState, dt: float = 1 / 60,
                   gravity: float = -9.8, box: float = 1.0,
                   restitution: float = 0.8) -> ParticleState:
    vel = state.vel + jnp.array([0.0, gravity, 0.0]) * dt
    pos = state.pos + vel * dt
    # Box bounce.
    below = pos < -box
    above = pos > box
    vel = jnp.where(below | above, -restitution * vel, vel)
    pos = jnp.clip(pos, -box, box)
    return ParticleState(pos=pos, vel=vel, age=state.age + dt)
