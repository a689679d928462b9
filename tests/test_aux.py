"""Aux subsystem tests: checkpointing, particles, mass-spring, config,
metrics, profiler, multi-device sharding dry run."""
import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fembrain.assets import sim_path
from fembrain.fem.integrator import FemState
from fembrain.fem.mass_spring import make_dumbbell, step_mass_spring
from fembrain.ops.particles import init_particles, step_particles
from fembrain.utils.checkpoint import load_pytree, save_pytree
from fembrain.utils.config import SimConfig
from fembrain.utils.metrics import MetricsLogger, Record
from fembrain.utils.profiler import Profiler


def test_checkpoint_roundtrip(tmp_path):
    state = FemState(
        q=jnp.asarray(np.random.default_rng(0).normal(size=(7, 3)), jnp.float32),
        qvel=jnp.ones((7, 3), jnp.float32),
    )
    p = tmp_path / "state.npz"
    save_pytree(p, state)
    loaded = load_pytree(p, state)
    np.testing.assert_allclose(np.asarray(loaded.q), np.asarray(state.q))
    np.testing.assert_allclose(np.asarray(loaded.qvel), np.asarray(state.qvel))


def test_particles_bounce_and_stay_in_box():
    st = init_particles(256, box=1.0)
    for _ in range(120):
        st = step_particles(st, dt=1 / 60, box=1.0)
    pos = np.asarray(st.pos)
    assert (pos >= -1.0 - 1e-5).all() and (pos <= 1.0 + 1e-5).all()
    assert float(st.age[0]) == pytest.approx(2.0, rel=1e-4)


def test_mass_spring_oscillates_and_damps():
    ms = make_dumbbell(separation=2.0, k=50.0)
    import dataclasses

    ms = dataclasses.replace(
        ms, pos=ms.pos.at[1, 0].set(1.5)  # stretch the spring
    )
    e0 = None
    for i in range(600):
        ms = step_mass_spring(ms, dt=1 / 120, damping=0.005)
        if i == 0:
            e0 = float(jnp.sum(ms.vel**2))
    # Ends drift toward rest separation with damped oscillation.
    sep = float(jnp.linalg.norm(ms.pos[1] - ms.pos[0]))
    assert abs(sep - 2.0) < 0.2
    assert float(jnp.sum(ms.vel**2)) < max(e0, 1.0)


def test_sim_config_roundtrip(tmp_path):
    cfg = SimConfig.load(sim_path("tumor"))
    assert cfg.input_file == "blobtree/tumor.blob"
    assert cfg.cellsize == pytest.approx(0.19)
    assert cfg.fixed_vertices == [7, 7, 7, 3, 6]
    assert cfg.force_coeff == 5000
    p = tmp_path / "out.sim"
    cfg.save(p)
    cfg2 = SimConfig.load(p)
    assert cfg2.cellsize == pytest.approx(cfg.cellsize)
    assert cfg2.fixed_vertices == cfg.fixed_vertices
    assert cfg2.cam_zoom == pytest.approx(cfg.cam_zoom)


def test_metrics_logger(tmp_path):
    p = tmp_path / "m.jsonl"
    db = tmp_path / "m.sqlite"
    ml = MetricsLogger(jsonl_path=p, sqlite_path=db)
    for i in range(3):
        ml.append(Record(model_name="t", fps=30.0 + i))
    ml.close()
    rows = [json.loads(l) for l in p.read_text().splitlines()]
    assert len(rows) == 3 and rows[2]["fps"] == 32.0
    import sqlite3

    con = sqlite3.connect(db)
    assert con.execute("SELECT COUNT(*) FROM experiments").fetchone()[0] == 3


def test_profiler():
    import time

    prof = Profiler()
    with prof.event("work"):
        time.sleep(0.01)
    s = prof.stats()["work"]
    assert s["count"] == 1 and s["avg_ms"] >= 9.0


def test_multichip_dryrun_8_devices():
    """The driver's multi-chip contract on the 8-device CPU mesh."""
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (1024, 3)
    assert np.isfinite(np.asarray(out)).all()
