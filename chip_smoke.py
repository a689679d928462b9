#!/usr/bin/env python
"""Smoke test of the production path on an NVIDIA GPU, at full size.

    python chip_smoke.py           # one card: phases 1-5 below
    python chip_smoke.py --four    # only the sharded coupled step on four
                                   # cards, against the one-card step

One card, on the shipped brain scene (data/models/brain.sim: 163 prims,
cellsize 0.14), rays at 1920x1080:
  1. device: the first JAX device must be a GPU; prints the card's name
     and power limit (nvidia-smi);
  2. app: fembrain.app.SimulationApp steps 5 frames under a haptic push,
     then renders one frame;
  3. production coupled frame (grid FEM -> Wendland interpolant ->
     deformed trace kernel) after a 40-step settle: asserts the trace
     kernel is the selected path and is in the compiled step, compares
     with the same step on the XLA tracer;
  4. rest trace: the kernel against render.sphere_trace.trace;
  5. gradient: d(image loss)/d(E_scale) through the differentiable
     coupled step, kernel path against XLA path.
Every comparison runs the XLA side with full-precision f32 matmuls and
fails if any f32 dot on a compared path runs at default precision (TF32
on this card). Any mismatch or exception exits non-zero; the last line of
stdout is the JSON result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HEIGHT, WIDTH = 1080, 1920
SCENE = "brain"
CELLSIZE = 0.14
SETTLE_STEPS = 40
CG_TOL = 1e-2          # forward-rendering CG tolerance (bench.py)
K_REFRESH = 4          # brain's march refresh cycle (bench.py)
N_CENTERS = 256

# Comparison rules, kernel vs XLA reference: hit masks agree on at least
# hit_agree of the rays; on rays that hit in both, the 99.9th percentile of
# |dt| stays under dt_p999 and, where set, the max under dt_max.
# Rest trace: the base rule (|dt| < 1e-4 on every common hit).
REST_RULE = dict(hit_agree=0.999, dt_p999=1e-4, dt_max=1e-4)
# Deformed trace, pull-back refreshed at every eval, against the XLA
# tracer with a converged inverse (PINNED_FP_ITERS fixed-point steps):
# both solve the same fixed point, the kernel warm-started and the XLA
# side from scratch, to f32 tolerance; rays nearly tangent to the surface
# magnify that into dt, so only the 99.9th percentile is bounded.
PINNED_FP_ITERS = 6
PINNED_RULE = dict(hit_agree=0.999, dt_p999=1e-3)
# Production coupled frame against the same step on the XLA tracer: the
# kernel march rides a linear rest-point model between pull-backs (a
# crossing it misplaces moves a root by up to a march step, about 0.03 on
# the brain) and the XLA step inverts the displacement with
# FIXED_POINT_ITERS steps from scratch (unconverged where the gradient of
# u is large). Both move single rays onto another surface, so the rule
# bounds how many rays are more than ~1.5 march steps off.
DEFORMED_RULE = dict(hit_agree=0.999, dt_p999=5e-2)
# The E-gradients differ only through the roots (zero-cotangent kernel,
# same implicit-hit correction on a common hit mask).
GRAD_RTOL = 2e-2


class SmokeError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def rays(width: int, height: int):
    import jax.numpy as jnp

    from fembrain.render.camera import Camera, generate_rays

    ro, rd = generate_rays(Camera.orbit(30.0, 20.0, 8.0), width, height)
    return jnp.reshape(ro, (-1, 3)), jnp.reshape(rd, (-1, 3))


def equations(fn, *args):
    """Every equation of fn's jaxpr, nested jaxprs included."""
    import jax
    import jax.extend.core as jcore

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            yield eqn
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                    if isinstance(sub, jcore.ClosedJaxpr):
                        yield from walk(sub.jaxpr)
                    elif isinstance(sub, jcore.Jaxpr):
                        yield from walk(sub)

    return list(walk(jax.make_jaxpr(fn)(*args).jaxpr))


def default_precision_dots(fn, *args) -> list[str]:
    """f32 dot_generals in fn's jaxpr that run at default precision (TF32
    on a GPU)."""
    import jax
    import jax.numpy as jnp
    from jax._src import source_info_util

    found = []
    for eqn in equations(fn, *args):
        if eqn.primitive.name != "dot_general":
            continue
        prec = eqn.params.get("precision")
        precs = prec if isinstance(prec, tuple) else (prec,)
        f32 = any(v.aval.dtype == jnp.float32 for v in eqn.invars)
        if f32 and all(p in (None, jax.lax.Precision.DEFAULT) for p in precs):
            found.append(source_info_util.summarize(eqn.source_info))
    return found


def count_kernels(fn, *args) -> int:
    """pallas_call equations in fn's jaxpr (nested jaxprs included)."""
    return sum(e.primitive.name == "pallas_call" for e in equations(fn, *args))


def compare(name, t_k, h_k, t_x, h_x, rule) -> dict:
    """Apply a comparison rule; returns the statistics it printed."""
    import numpy as np

    h_k, h_x = np.asarray(h_k), np.asarray(h_x)
    both = h_k & h_x
    dt = np.abs(np.asarray(t_k)[both] - np.asarray(t_x)[both])
    stats = {
        "rays": int(h_k.size),
        "hits_kernel": int(h_k.sum()),
        "hits_xla": int(h_x.sum()),
        "hit_agree": float((h_k == h_x).mean()),
        "dt_max": float(dt.max()) if dt.size else 0.0,
        "dt_p999": float(np.quantile(dt, 0.999)) if dt.size else 0.0,
        "dt_median": float(np.median(dt)) if dt.size else 0.0,
    }
    print(f"{name}: {json.dumps(stats)}")
    check(np.isfinite(np.asarray(t_k)).all(), f"{name}: non-finite t")
    check(stats["hits_xla"] > 0, f"{name}: no ray hits")
    check(stats["hit_agree"] >= rule["hit_agree"],
          f"{name}: hit agreement {stats['hit_agree']} < {rule['hit_agree']}")
    check(stats["dt_p999"] < rule["dt_p999"],
          f"{name}: p99.9 |dt| {stats['dt_p999']} >= {rule['dt_p999']}")
    if "dt_max" in rule:
        check(stats["dt_max"] < rule["dt_max"],
              f"{name}: max |dt| {stats['dt_max']} >= {rule['dt_max']}")
    return stats


def timed(fn, *args, reps=3):
    """(seconds per call after a warm-up call, last output)."""
    import jax

    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / reps, out


def phase_app(width=WIDTH, height=HEIGHT, frames=5):
    """SimulationApp on brain.sim: haptic push for `frames` frames, then
    one rendered frame."""
    import numpy as np

    from fembrain.app import SimulationApp
    from fembrain.assets import sim_path

    app = SimulationApp(sim_path(SCENE))
    nodes = np.asarray(app.fem.rest)
    tip = np.asarray([int(np.argmax(nodes[:, 1]))])
    push = np.asarray([[0.0, -2000.0, 0.0]], np.float32)
    for _ in range(frames):
        app.timestep(haptic=(tip, push))
    q = np.asarray(app.deformable.state.q)
    check(np.isfinite(q).all(), "app: non-finite FEM state")
    check(np.abs(q).max() > 0.0, "app: the haptic push moved nothing")
    t0 = time.perf_counter()
    img = app.render_frame(width=width, height=height)
    dt = time.perf_counter() - t0
    check(img.shape == (height, width, 3) and np.isfinite(img).all(),
          "app: bad rendered frame")
    check((img < 0.99).any(), "app: the rendered frame is blank")
    print(f"app: {app.fem.n_nodes} nodes {app.fem.n_tets} tets, "
          f"max|q|={np.abs(q).max():.5f}, render {width}x{height} "
          f"{dt:.2f} s (compile included)")
    app.close()


def coupled_setup(cellsize=CELLSIZE, n_centers=N_CENTERS):
    """The production coupled frame's inputs (bench.py _coupled_metric):
    brain grid FEM anchored per component, Wendland interpolant, a
    gravity-like body force, state settled for SETTLE_STEPS steps."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    from fembrain.assets import load_scene
    from fembrain.fem import grid_fem as gfm
    from fembrain.mesh.polygonize import extract_tet_mesh, grid_for_scene
    from fembrain.mesh.samples import bottom_nodes_per_component
    from fembrain.render.deformed import build_disp_interp

    scene = load_scene(SCENE)
    grid = grid_for_scene(scene, cellsize=cellsize)
    tm = extract_tet_mesh(scene, grid, ncap=grid.n_vertices,
                          tetcap=grid.n_cells * 6)
    nodes = np.asarray(tm.nodes)[: int(tm.n_nodes)]
    tets = np.asarray(tm.tets)[: int(tm.n_tets)]
    fixed = bottom_nodes_per_component(nodes, tets, frac=0.25)
    gf = gfm.grid_fem_from_tetmesh(grid, tm, fixed_nodes=fixed)
    interp = build_disp_interp(nodes, n_centers=n_centers, fixed=fixed,
                               kernel="wendland", sigma_fill=2.5)
    n2g = gfm.node_to_grid_index(tm)
    cgi = jnp.asarray(n2g[np.asarray(interp.center_nodes)])
    f_ext = np.zeros((int(np.prod(grid.dims)), 3), np.float32)
    f_ext[n2g, 1] = -500.0 * np.asarray(gf.mass).reshape(-1)[n2g]
    f_ext = jnp.asarray(f_ext.reshape(*grid.dims, 3))

    @jax.jit
    def settle(st):
        def body(st, _):
            return gfm.timestep(gf, st, f_ext)[0], None
        return jax.lax.scan(body, st, None, length=SETTLE_STEPS)[0]

    st0 = jax.block_until_ready(settle(gf.rest_state()))
    bound_pts = jnp.asarray(nodes[:: max(1, len(nodes) // 4096)])
    return dict(scene=scene, grid=grid, tm=tm, nodes=nodes, fixed=fixed,
                gf=gf, interp=interp, cgi=cgi, f_ext=f_ext, st0=st0,
                bound_pts=bound_pts)


def production_step(cs, width, height, use_pallas=None, interpret=False):
    """The production coupled frame as bench.py builds it:
    f(state, ro, rd) -> (t, hit, state')."""
    from fembrain.render.deformed import coupled_step_grid_fast

    def f(st, o, d):
        return coupled_step_grid_fast(
            cs["scene"], cs["gf"], cs["interp"], cs["cgi"], st, cs["f_ext"],
            o, d, image_hw=(height, width), use_pallas=use_pallas,
            interpret=interpret, bound_pts=cs["bound_pts"], cg_tol=CG_TOL,
            k_refresh=K_REFRESH,
        )
    return f


def phase_coupled(cs, width=WIDTH, height=HEIGHT, interpret=False,
                  frames=3):
    """Production coupled frames on the selected path vs the XLA tracer."""
    import numpy as np

    import jax

    from fembrain.render.deformed import (
        disp_weights_centers,
        frame_max_disp,
        trace_deformed_rbf_fast,
    )
    from fembrain.render.pallas_trace import select_trace_path

    scene, interp = cs["scene"], cs["interp"]
    path = select_trace_path(scene, deformed=interp.kind,
                             interpret=interpret)
    print(f"coupled: selected path: {path}")
    check(path.kernel and path.interpret == interpret,
          f"coupled: the trace kernel is not the selected path ({path})")
    ro, rd = rays(width, height)
    prod = production_step(cs, width, height, None, interpret)
    ref = production_step(cs, width, height, False, interpret)
    n_k = count_kernels(prod, cs["st0"], ro, rd)
    check(n_k > 0, "coupled: no trace kernel in the production step")
    check(count_kernels(ref, cs["st0"], ro, rd) == 0,
          "coupled: a kernel in the XLA reference step")
    bad = default_precision_dots(ref, cs["st0"], ro, rd)
    bad += default_precision_dots(prod, cs["st0"], ro, rd)
    check(not bad, f"coupled: default-precision f32 dots: {bad}")

    prod_j, ref_j = jax.jit(prod), jax.jit(ref)
    st = cs["st0"]
    t0 = time.perf_counter()
    jax.block_until_ready(prod_j(st, ro, rd))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        t_k, h_k, st = jax.block_until_ready(prod_j(st, ro, rd))
        times.append(time.perf_counter() - t0)
    # Same state into both paths for the comparison frame.
    t_k, h_k, st_k = jax.block_until_ready(prod_j(st, ro, rd))
    x_s, (t_x, h_x, st_x) = timed(ref_j, st, ro, rd, reps=1)
    check(np.allclose(np.asarray(st_k.q), np.asarray(st_x.q), atol=1e-6),
          "coupled: the FEM states of the two paths differ")
    q = np.asarray(st_k.q)
    check(np.isfinite(q).all() and np.abs(q).max() > 0,
          "coupled: bad FEM state")
    print(f"coupled: frame ms (kernel path, info only) "
          f"{[round(1e3 * s, 3) for s in times]}; XLA-tracer frame "
          f"{1e3 * x_s:.3f} ms; first call {compile_s:.1f} s; "
          f"max|q|={np.abs(q).max():.5f}; kernels in step={n_k}")
    stats = compare("coupled frame (kernel vs XLA)", t_k, h_k, t_x, h_x,
                    DEFORMED_RULE)

    # The kernel's pull-back itself, on the frame's displacement: refresh
    # at every eval against the converged XLA inverse.
    w = disp_weights_centers(interp, st_k.q.reshape(-1, 3)[cs["cgi"]])
    md = frame_max_disp(interp, w)

    def pinned(use_pallas):
        return jax.jit(lambda w_, o, d: trace_deformed_rbf_fast(
            scene, interp, w_, o, d, max_disp=md, image_hw=(height, width),
            interpret=interpret, fp_iters=PINNED_FP_ITERS, need_grads=False,
            bound_pts=cs["bound_pts"], k_refresh=1, use_pallas=use_pallas,
        ))

    t_k, h_k = pinned(True)(w, ro, rd)
    t_x, h_x = pinned(False)(w, ro, rd)
    compare("deformed trace, per-eval pull-back (kernel vs XLA, converged)",
            t_k, h_k, t_x, h_x, PINNED_RULE)
    return stats


def phase_rest(scene, width=WIDTH, height=HEIGHT, interpret=False):
    """Rest trace: the block-coherent kernel vs the XLA tracer."""
    import jax

    from fembrain.render.pallas_trace import trace_pallas_image
    from fembrain.render.sphere_trace import trace

    ro, rd = rays(width, height)
    check(not default_precision_dots(lambda s, o, d: trace(s, o, d),
                                     scene, ro, rd),
          "rest: default-precision f32 dots in the XLA tracer")
    k_s, (t_k, h_k) = timed(jax.jit(
        lambda s, o, d: trace_pallas_image(s, o, d, height, width,
                                           interpret=interpret)
    ), scene, ro, rd)
    x_s, (t_x, h_x) = timed(jax.jit(trace), scene, ro, rd)
    print(f"rest: kernel {1e3 * k_s:.3f} ms, XLA tracer {1e3 * x_s:.3f} ms "
          f"({width}x{height}, info only)")
    return compare("rest trace (kernel vs XLA)", t_k, h_k, t_x, h_x,
                   REST_RULE)


def phase_grad(cs, width=WIDTH, height=HEIGHT, interpret=False):
    """d(mean hit depth)/d(E_scale) through the differentiable coupled
    step, kernel path vs XLA path, on the rays both paths hit. Each path
    compiles once: the hit mask is an input of its jitted value-and-grad,
    and the first call (all rays) returns the path's own hits."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    from fembrain.render.deformed import coupled_step_grid_fast

    ro, rd = rays(width, height)

    def loss(use_pallas):
        def f(es, mask):
            t, hit, _ = coupled_step_grid_fast(
                cs["scene"], cs["gf"], cs["interp"], cs["cgi"], cs["st0"],
                cs["f_ext"], ro, rd, E_scale=es, image_hw=(height, width),
                use_pallas=use_pallas, interpret=interpret,
                differentiable=True, bound_pts=cs["bound_pts"],
                k_refresh=K_REFRESH,
            )
            m = mask & jax.lax.stop_gradient(hit)
            return jnp.sum(jnp.where(m, t, 0.0)) / jnp.sum(m), hit
        return f

    one = jnp.float32(1.0)
    everything = jnp.ones(width * height, bool)
    bad = default_precision_dots(jax.grad(loss(False), has_aux=True),
                                 one, everything)
    check(not bad, f"grad: default-precision f32 dots: {bad}")
    grad_k = jax.jit(jax.grad(loss(None), has_aux=True))
    grad_x = jax.jit(jax.grad(loss(False), has_aux=True))
    t0 = time.perf_counter()
    _, h_k = grad_k(one, everything)
    _, h_x = grad_x(one, everything)
    first_s = time.perf_counter() - t0
    mask = jnp.asarray(np.asarray(h_k) & np.asarray(h_x))
    g_k = float(grad_k(one, mask)[0])
    g_x = float(grad_x(one, mask)[0])
    rel = abs(g_k - g_x) / max(abs(g_x), 1e-30)
    print(f"grad: dE kernel {g_k:.6e} XLA {g_x:.6e} rel diff {rel:.3e} "
          f"({int(mask.sum())} common hit rays; first calls {first_s:.1f} s)")
    check(np.isfinite(g_k) and np.isfinite(g_x), "grad: non-finite")
    check(g_k != 0.0 and g_x != 0.0, "grad: zero gradient")
    check(rel < GRAD_RTOL, f"grad: rel diff {rel} >= {GRAD_RTOL}")
    return rel


def phase_four(width=WIDTH, height=HEIGHT, n_dev=4, interpret=False,
               frames=1, cellsize=CELLSIZE, n_centers=N_CENTERS):
    """The sharded coupled step (X-slab grid FEM + replicated Wendland
    weights + ray-sharded trace kernel) over n_dev devices against the
    one-device production step (phase_coupled's), from the same settled
    state, with the same interpolant."""
    import numpy as np

    import jax

    from fembrain.fem import grid_sharded as gsh
    from fembrain.render.coupled_sharded import (
        build_coupled_grid_sharded,
        coupled_step_grid_sharded,
    )
    from fembrain.render.pallas_trace import select_trace_path

    check(len(jax.devices()) >= n_dev,
          f"four: needs {n_dev} devices, found {len(jax.devices())}")
    cs = coupled_setup(cellsize, n_centers)
    interp = cs["interp"]
    cgs = build_coupled_grid_sharded(
        cs["grid"], cs["tm"], n_dev, fixed_nodes=cs["fixed"], interp=interp,
    )
    path = select_trace_path(cs["scene"], deformed=interp.kind,
                             interpret=interpret)
    check(path.kernel, f"four: the trace kernel is not selected ({path})")
    mesh = gsh.make_grid_mesh(n_dev)
    ro, rd = rays(width, height)
    fs = gsh.to_shard_layout(cgs.sgf, cs["f_ext"])
    kw = dict(image_hw=(height, width), interpret=interpret, cg_tol=CG_TOL,
              k_refresh=K_REFRESH)
    one = jax.jit(production_step(cs, width, height, None, interpret))

    @jax.jit
    def sharded(q, v, dv, o, d):
        t, hit, (q2, v2, dv2), _ = coupled_step_grid_sharded(
            cs["scene"], cgs, mesh, q, v, dv, fs, o, d, E_scale=None, **kw
        )
        return t, hit, (q2, v2, dv2)

    check(count_kernels(sharded, *[gsh.to_shard_layout(cgs.sgf, a) for a in
                                   (cs["st0"].q, cs["st0"].qvel,
                                    cs["st0"].dv)], ro, rd) > 0,
          "four: no trace kernel in the sharded step")
    st = cs["st0"]
    q, v, dv = (gsh.to_shard_layout(cgs.sgf, a)
                for a in (st.q, st.qvel, st.dv))
    s_s, (t_s, h_s, (q, v, dv)) = timed(sharded, q, v, dv, ro, rd, reps=1)
    o_s, (t_1, h_1, st) = timed(one, st, ro, rd, reps=1)
    for _ in range(frames - 1):
        t_s, h_s, (q, v, dv) = jax.block_until_ready(
            sharded(q, v, dv, ro, rd))
        t_1, h_1, st = jax.block_until_ready(one(st, ro, rd))
    qg = np.asarray(gsh.from_shard_layout(cgs.sgf, q))
    q1 = np.asarray(st.q)
    dq = float(np.abs(qg - q1).max())
    scale = float(np.abs(q1).max())
    print(f"four: {n_dev}-device frame {1e3 * s_s:.3f} ms, one-device "
          f"frame {1e3 * o_s:.3f} ms (info only); max|dq| {dq:.3e} of "
          f"max|q| {scale:.3e}")
    check(np.isfinite(qg).all() and scale > 0, "four: bad FEM state")
    check(dq <= 1e-3 * scale, f"four: FEM states differ ({dq} > 1e-3 max|q|)")
    return compare(f"four ({n_dev}-device vs one-device trace)", t_s, h_s,
                   t_1, h_1, REST_RULE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded coupled step on four cards")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    try:
        import fembrain  # noqa: F401
    except ImportError:
        print("chip_smoke: the fembrain package is not beside this script",
              file=sys.stderr)
        return 2
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    from fembrain.utils.checkpoint import enable_compilation_cache

    print(f"compile cache: {enable_compilation_cache()}")
    print(f"card: {card_line()}")
    print(f"jax {jax.__version__}; devices: {len(jax.devices())} x "
          f"{dev.device_kind}")
    t_all = time.perf_counter()
    if args.four:
        phase_four()
    else:
        phase_app()
        cs = coupled_setup()
        phase_coupled(cs)
        phase_rest(cs["scene"])
        phase_grad(cs)
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
