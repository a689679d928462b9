"""The coupled E-gradient bench check (tools/egrad_check.py) stays green.

Runs the f64 subprocess check bench.py invokes: one process-global x64
flag means it must be a subprocess here too. Pins the project's
central differentiability claim: d(image loss)/d(Young's modulus) through
custom_linear_solve + RBF weights + implicit hit differentiation matches
finite differences (BASELINE 'grad-check'; VERDICT r3 next-round #2)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.slow
def test_coupled_e_grad_f64():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "JAX_ENABLE_X64")}
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "egrad_check.py")],
        capture_output=True, text=True, timeout=540, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["hit_flips"] == 0
    assert res["rel_err"] < 1e-2, res
