"""Residual-matched Jacobi-vs-SOR comparison.

Comparing the two pressure solvers at EQUAL n_iter is iteration-matched,
not accuracy-matched: one SOR sweep pair (Gauss-Seidel coloring, ω=1.3,
fs/pressure_updater.py:70-114) converges faster per iteration than one
Jacobi ping-pong (fs/pressure_updater.py:42-66). This script sweeps
n_pressure_iter for BOTH solvers at the headline config and reports,
per (solver, n_iter): the settled post-step RMS divergence over fluid
cells (the quantity the pressure projection drives down) and the
steps/s — so the honest comparison reads "steps/s at equal residual".

Method: run `--settle` steps from the cold start so the divergence
statistic reflects developed flow, measure RMS divergence averaged over
the NEXT `--probe` steps (it fluctuates step to step), then time
`--steps` steps. Rates are device rates only when JAX runs on a GPU;
the backend is printed first.

Usage: python scripts/solver_residual_bench.py
        [--res 1600] [--iters 1,2,4,6] [--steps 200]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

from fluid2d_tpu.config import SimConfig
from fluid2d_tpu.models.simulator import make_run_fn, scene_for_dtype
from fluid2d_tpu.scenes.compile import get_scene
from fluid2d_tpu.state import init_state
from fluid2d_tpu.utils.metrics import divergence


def make_cfg(res, solver, n_iter):
    return SimConfig.create(
        resolution=res, re=1_000_000.0, scheme="cip", vor_eps=5.0,
        enable_dye=True, pressure_solver=solver, n_pressure_iter=n_iter,
    )


def run_one(res, solver, n_iter, settle, probe, steps, bc=2):
    cfg = make_cfg(res, solver, n_iter)
    scene = scene_for_dtype(get_scene(bc, res), cfg)
    state = init_state(scene, cfg)
    run = make_run_fn(cfg)

    state = run(state, scene, settle)

    # Post-step RMS divergence over fluid cells, averaged over `probe`
    # consecutive steps of the developed flow.
    fluid = scene.fluid
    n_fluid = float(fluid.sum())

    @jax.jit
    def div_rms(state):
        d = jnp.where(fluid, divergence(state.v, cfg.dx), 0.0)
        return jnp.sqrt((d.astype(jnp.float64 if jax.config.jax_enable_x64
                                  else jnp.float32) ** 2).sum() / n_fluid)

    resid = []
    for _ in range(probe):
        state = run(state, scene, 2)  # keep the 2-step parity
        resid.append(float(div_rms(state)))
    resid_mean = float(np.mean(resid))

    # Timed run (same discipline as bench.py).
    state = jax.block_until_ready(run(state, scene, steps))  # warm n=steps
    t0 = time.perf_counter()
    state = jax.block_until_ready(run(state, scene, steps))
    rate = steps / (time.perf_counter() - t0)
    return resid_mean, rate


if __name__ == "__main__":
    from fluid2d_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=1600)
    ap.add_argument("--iters", type=str, default="1,2,3,4,6")
    ap.add_argument("--settle", type=int, default=400)
    ap.add_argument("--probe", type=int, default=10)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()
    iters = [int(s) for s in args.iters.split(",")]

    print(f"backend: {jax.default_backend()}  res={args.res}")
    rows = []
    for solver in ("sor", "jacobi"):
        for n in iters:
            resid, rate = run_one(args.res, solver, n,
                                  args.settle, args.probe, args.steps)
            rows.append((solver, n, resid, rate))
            print(f"{solver:6s} n_iter={n}: div_rms={resid:.4e}  "
                  f"{rate:7.1f} steps/s", flush=True)
    print("\n| solver | n_iter | RMS divergence | steps/s |")
    print("|---|---|---|---|")
    for solver, n, resid, rate in rows:
        print(f"| {solver} | {n} | {resid:.3e} | {rate:.1f} |")
