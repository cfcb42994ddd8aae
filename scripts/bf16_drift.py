"""How far does the bf16 transport trajectory drift from f32?

The bfloat16 transport mode (SimConfig.dtype, docs/PARITY.md §9) rounds
every phase output to 8 mantissa bits. The per-step injection is
O(2^-9) relative per field, but fluid steps feed back — pressure reads
velocity divergence, advection reads everything — so the question a
user of the fast path actually has is the accumulated divergence over a
real horizon, not the per-phase bound.

This script runs the same seeded scene under both transports and records
the relative error of v / p / dye against the f32 run at a geometric
checkpoint schedule, plus the f32 run's own diagnostics as scale
context, as one JSON line.

CPU (small res):    python scripts/bf16_drift.py --res 64 --steps 200 --cpu
GPU (bench scale):  python scripts/bf16_drift.py --res 1600 --steps 2000
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def rel_err(a, b):
    """max and RMS of |a−b| over the f32 run's max|field| scale."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-6)
    d = np.abs(a - b)
    return float(d.max() / scale), float(np.sqrt((d * d).mean()) / scale)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--bc", type=int, default=2)
    p.add_argument("--scheme", type=str, default="cip",
                   choices=["upwind", "kk", "cip"])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--points", type=int, default=6,
                   help="number of checkpoints (geometric up to --steps)")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        from fluid2d_tpu.utils.cache import enable_compile_cache

        enable_compile_cache()

    from fluid2d_tpu.config import SimConfig
    from fluid2d_tpu.models.simulator import make_run_fn, scene_for_dtype
    from fluid2d_tpu.scenes.compile import get_scene
    from fluid2d_tpu.state import init_state
    from fluid2d_tpu.utils.metrics import _diag_arrays

    # Geometric checkpoint schedule: 1, ~r, ~r², …, steps.
    marks, m = [], 1
    while m < args.steps:
        marks.append(m)
        m = max(m + 1, int(round(m * (args.steps ** (1 / (args.points - 1))))))
    marks.append(args.steps)

    runs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = SimConfig.create(resolution=args.res, re=1e6, scheme=args.scheme,
                               vor_eps=5.0, enable_dye=True, dtype=dtype)
        scene = scene_for_dtype(get_scene(args.bc, args.res), cfg)
        state = init_state(scene, cfg)
        run = make_run_fn(cfg)
        snaps, done = [], 0
        import numpy as np

        for m in marks:
            state = run(state, scene, m - done)
            done = m
            # Materialize: the scan donates its input state, so a live
            # snapshot would be deleted by the next run() call.
            snaps.append(state._replace(**{
                f: np.asarray(leaf, np.float32)
                for f, leaf in zip(state._fields, state)
                if leaf is not None and f != "step"
            }))
        runs[dtype] = (snaps, scene, cfg)

    rows = []
    for i, m in enumerate(marks):
        s16 = runs["bfloat16"][0][i]
        s32 = runs["float32"][0][i]
        row = {"step": m}
        for name in ("v", "p", "dye"):
            a, b = getattr(s16, name), getattr(s32, name)
            if a is None:
                continue
            mx, rms = rel_err(a, b)
            row[f"{name}_max"] = round(mx, 5)
            row[f"{name}_rms"] = round(rms, 6)
        div_rms, _, _, _ = _diag_arrays(
            s32.v, s32.p, runs["float32"][1].fluid, runs["float32"][2].dx
        )
        row["f32_div_rms"] = round(float(div_rms), 5)
        row["bf16_nan"] = bool(jax.numpy.isnan(s16.v.astype("float32")).any())
        rows.append(row)
        print(f"# step {m:6d}: "
              + "  ".join(f"{k}={v}" for k, v in row.items() if k != "step"),
              file=sys.stderr)

    print(json.dumps({
        "res": args.res, "bc": args.bc, "scheme": args.scheme,
        "backend": jax.default_backend(),
        "drift": rows,
    }))


if __name__ == "__main__":
    main()
