"""chip_smoke.py: its checks on the GPU (marked `gpu`, skipped here), and
on the CPU the parts that need no card — the comparison rule, the jaxpr
checks, and the refusal to run without a GPU."""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import chip_smoke
from fembrain.assets import load_scene
from fembrain.render.pallas_trace import trace_pallas


def test_refuses_without_gpu(capsys):
    """No GPU: a non-zero exit and no result line."""
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_compare_rule():
    t = np.linspace(1.0, 2.0, 4000).astype(np.float32)
    hit = np.ones(4000, bool)
    stats = chip_smoke.compare("same", t, hit, t, hit, chip_smoke.REST_RULE)
    assert stats["hit_agree"] == 1.0 and stats["dt_max"] == 0.0
    far = t.copy()
    far[:10] += 1.0  # 0.25% of the rays off by a whole unit
    with pytest.raises(chip_smoke.SmokeError, match="p99.9"):
        chip_smoke.compare("far", far, hit, t, hit, chip_smoke.REST_RULE)
    flips = hit.copy()
    flips[:20] = False
    with pytest.raises(chip_smoke.SmokeError, match="hit agreement"):
        chip_smoke.compare("flips", t, flips, t, hit, chip_smoke.REST_RULE)


def test_default_precision_dots_found():
    a = jnp.ones((8, 8), jnp.float32)
    assert chip_smoke.default_precision_dots(lambda x: x @ x, a)
    assert not chip_smoke.default_precision_dots(
        lambda x: jnp.matmul(x, x, precision=jax.lax.Precision.HIGHEST), a
    )
    # Nested jaxprs (loops) are searched too.
    assert chip_smoke.default_precision_dots(
        lambda x: jax.lax.fori_loop(0, 2, lambda i, y: y @ y, x), a
    )


def test_count_kernels():
    scene = load_scene("sphere")
    ro = jnp.zeros((16, 3)).at[:, 2].set(-3.0)
    rd = jnp.zeros((16, 3)).at[:, 2].set(1.0)
    n = chip_smoke.count_kernels(
        lambda o, d: trace_pallas(scene, o, d, interpret=True), ro, rd
    )
    assert n == 1
    assert chip_smoke.count_kernels(lambda o: o * 2.0, ro) == 0


@pytest.fixture(scope="module")
def small_setup():
    """The coupled phases' inputs at CI size (cellsize 0.3, 64 centers)."""
    return chip_smoke.coupled_setup(cellsize=0.3, n_centers=64)


def test_phases_in_interpret_mode(small_setup):
    """chip_smoke's one-card phases end to end on the CPU with the trace
    kernel in interpret mode, at a tiny image: the selected-path and
    kernel-in-step assertions, the precision checks and the comparison
    rules all run."""
    stats = chip_smoke.phase_coupled(small_setup, 64, 36, interpret=True,
                                     frames=1)
    assert stats["hits_xla"] > 0
    stats = chip_smoke.phase_rest(small_setup["scene"], 64, 36,
                                  interpret=True)
    assert stats["hit_agree"] >= chip_smoke.REST_RULE["hit_agree"]
    assert chip_smoke.phase_grad(small_setup, 32, 18, interpret=True) < (
        chip_smoke.GRAD_RTOL)


def test_four_device_phase_in_interpret_mode():
    """chip_smoke --four's path on 4 of the 8 virtual CPU devices."""
    stats = chip_smoke.phase_four(64, 36, n_dev=4, interpret=True, frames=1,
                                  cellsize=0.3)
    assert stats["hit_agree"] == 1.0


@pytest.mark.gpu
def test_rest_trace_on_gpu(gpu):
    chip_smoke.phase_rest(load_scene("brain"), 480, 270)


@pytest.mark.gpu
def test_coupled_and_gradient_on_gpu(gpu):
    cs = chip_smoke.coupled_setup()
    chip_smoke.phase_coupled(cs, 480, 270)
    chip_smoke.phase_grad(cs, 480, 270)


@pytest.mark.gpu
def test_result_line_on_gpu(gpu, capsys):
    """The full smoke run ends in the contract line."""
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    res = json.loads(last)
    assert res["ok"] is True and res["device"]["platform"] == "gpu"
