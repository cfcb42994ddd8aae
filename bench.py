"""Benchmark harness: simulated steps per second on one GPU.

Headline metric (BASELINE.json): steps/s at res=1600 with CIP advection
+ red-black SOR (+dye +vorticity confinement, the reference's defaults).
``--config N`` runs one of the BASELINE presets 1-6, ``--config all``
every one of them.

The measurement path needs a GPU: without one it exits non-zero and
prints no number. Every JSON line names the device it was taken on
(platform, device kind, device count, the card's name and power limit).

Usage: python bench.py [--res 1600] [--scheme cip] [--steps 200]
                       [--dtype float32|bfloat16] [--config N|all] [--all]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def require_gpu() -> dict:
    """The device record for every result line; exits non-zero when JAX
    finds no GPU (a CPU rate is not a device metric)."""
    import jax

    from fluid2d_tpu.utils.cache import enable_compile_cache
    from fluid2d_tpu.utils.profiling import device_info

    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found no GPU (platform {platform!r})")
    enable_compile_cache()
    return device_info()


def make_case(res: int, scheme: str, *, enable_dye=True, vor_eps=5.0, bc=2,
              re=1_000_000.0, dt=None, dtype="float32"):
    """(cfg, scene, zero state) of one configuration, on the default device."""
    from fluid2d_tpu.config import SimConfig
    from fluid2d_tpu.models.simulator import scene_for_dtype
    from fluid2d_tpu.scenes.compile import get_scene
    from fluid2d_tpu.state import init_state

    cfg = SimConfig.create(
        resolution=res, re=re, dt=dt, scheme=scheme, vor_eps=vor_eps,
        enable_dye=enable_dye, dtype=dtype,
    )
    scene = scene_for_dtype(get_scene(bc, res), cfg)
    return cfg, scene, init_state(scene, cfg)


def bench_config(res: int, scheme: str, steps: int, **kw):
    """(steps/s, final state) of `steps` steps after a warm-up of the same
    length; `kw` as for :func:`make_case`."""
    import jax

    from fluid2d_tpu.models.simulator import make_run_fn

    cfg, scene, state = make_case(res, scheme, **kw)
    run = make_run_fn(cfg)

    # Warmup with the SAME static step count so the timed call reuses the
    # compiled executable (scan length is a static argument — a different
    # n would recompile inside the timing).
    state = jax.block_until_ready(run(state, scene, steps))

    t0 = time.perf_counter()
    state = jax.block_until_ready(run(state, scene, steps))
    elapsed = time.perf_counter() - t0
    return steps / elapsed, state


# The BASELINE.json configs as named presets: one command reproduces the
# whole table. Step counts keep each timed run at a second or more.
PRESETS = {
    1: {"desc": "bc=1 channel flow, res=400, upwind, Re=1000, dt=5e-4",
        "kw": {"res": 400, "scheme": "upwind", "bc": 1, "re": 1000.0,
               "dt": 5e-4, "vor_eps": None, "enable_dye": False},
        "steps": 2000},
    2: {"desc": "bc=2 obstacle flow, res=800, Kawamura-Kuwahara, Re=1000",
        "kw": {"res": 800, "scheme": "kk", "bc": 2, "re": 1000.0},
        "steps": 1000},
    3: {"desc": "bc=3 Re=1e8, res=800, CIP + vorticity confinement vc=10",
        "kw": {"res": 800, "scheme": "cip", "bc": 3, "re": 1e8, "vor_eps": 10.0},
        "steps": 600},
    4: {"desc": "bc=5 multi-obstacle mask, res=1600, CIP + dye/vorticity",
        "kw": {"res": 1600, "scheme": "cip", "bc": 5},
        "steps": 300},
    5: {"desc": "bc=6 dragon mask, res=1600, CIP + dye/vorticity",
        "kw": {"res": 1600, "scheme": "cip", "bc": 6},
        "steps": 300},
    6: {"desc": "res=4096 obstacle sweep (bc=3), CIP, one card",
        "kw": {"res": 4096, "scheme": "cip", "bc": 3},
        "steps": 80},
}


def _finite(state) -> bool:
    import numpy as np

    return bool(np.isfinite(np.asarray(state.v, np.float32)).all())


def run_preset(n: int, device: dict, dtype: str = "float32") -> dict:
    p = PRESETS[n]
    rate, state = bench_config(steps=p["steps"], dtype=dtype, **p["kw"])
    finite = _finite(state)
    metric = f"baseline_config_{n}"
    if dtype != "float32":
        metric += f"_{dtype}"
    return {
        "metric": metric,
        "desc": p["desc"],
        "value": round(rate, 2) if finite else 0.0,
        "unit": "steps/s",
        "stable": finite,
        "device": device,
    }


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--res", type=int, default=1600)
    parser.add_argument("--scheme", type=str, default="cip", choices=["upwind", "kk", "cip"])
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="Transport (storage) dtype; arithmetic stays f32 "
                             "(the headline metric stays float32 = reference "
                             "parity)")
    parser.add_argument("--all", action="store_true",
                        help="Also print a res × scheme side table to stderr")
    parser.add_argument("--config", type=str, default=None,
                        help="BASELINE.json preset number 1..6, or 'all'")
    args = parser.parse_args(argv)

    device = require_gpu()

    if args.config:
        nums = sorted(PRESETS) if args.config == "all" else [int(args.config)]
        for n in nums:
            row = run_preset(n, device, args.dtype)
            print(f"# config {n}: {row['value']:9.1f} steps/s "
                  f"stable={row['stable']}  ({row['desc']})", file=sys.stderr)
            print(json.dumps(row), flush=True)
        return

    if args.all:
        for res, steps in ((400, 2000), (800, 1000), (1600, 400), (4096, 80)):
            for scheme in ("upwind", "kk", "cip"):
                rate, _ = bench_config(res, scheme, steps)
                print(f"# res={res:5d} scheme={scheme:6s}: {rate:9.1f} steps/s", file=sys.stderr)

    rate, state = bench_config(args.res, args.scheme, args.steps, dtype=args.dtype)
    metric = f"steps_per_sec_res{args.res}_{args.scheme}"
    if args.dtype != "float32":
        metric += f"_{args.dtype}"
    finite = _finite(state)  # a benchmark of NaNs is not a benchmark
    print(json.dumps({
        "metric": metric,
        "value": round(rate, 2) if finite else 0.0,
        "unit": "steps/s",
        "stable": finite,
        "device": device,
    }))


if __name__ == "__main__":
    main()
