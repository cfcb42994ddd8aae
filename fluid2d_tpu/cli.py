"""Command-line interface.

Mirrors the reference CLI's flag surface (``/root/reference/main.py:11-51``)
and adds what a headless accelerator host needs: a bounded step count, frame/PNG
output instead of a GUI window, checkpointing, and performance logging.
The reference's interactive keys map to flags: ``s`` (screenshot) →
``--save-frames``, ``d`` (field dump) → ``--dump-fields`` /
``--checkpoint``, ``v`` (cycle vis) → ``-vis``.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path


# Fresh-run defaults for the flags whose "explicitly passed?" status
# matters on --resume. The parser uses argparse.SUPPRESS as the default
# (the attribute is simply absent when a flag wasn't typed), so an
# explicitly re-passed default value is still recognized as explicit —
# e.g. `--resume ckpt --pressure-iters 2` restores 2 on a checkpoint
# saved with 4. resolve_args() fills the absentees in from this table.
DEFAULTS = {
    "boundary_condition": None,  # None ⇔ "use the checkpoint's scene" on resume
    "reynolds_num": 1_000_000.0,
    "resolution": 400,
    "time_step": 0.0,
    "vorticity_confinement": 5.0,
    "advection_scheme": "cip",
    "no_dye": False,
    "pressure_solver": "sor",
    "sor_omega": 1.3,
    "pressure_iters": 2,
    "dtype": "float32",
    "mask_image": "",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="2D incompressible fluid simulator")
    unset = argparse.SUPPRESS
    parser.add_argument("-bc", "--boundary_condition", type=int,
                        choices=[1, 2, 3, 4, 5, 6], default=unset,
                        help="Boundary condition scene number (default 1)")
    parser.add_argument("-re", "--reynolds_num", type=float, default=unset,
                        help="Reynolds number (default 1e6)")
    parser.add_argument("-res", "--resolution", type=int, default=unset,
                        help="Resolution of y-axis (grid is 2·res × res; default 400)")
    parser.add_argument("-dt", "--time_step", type=float, default=unset,
                        help="Time step (0 → 0.05/resolution)")
    parser.add_argument("-vis", "--visualization", type=int,
                        choices=[0, 1, 2, 3], default=0,
                        help="0: velocity norm + pressure, 1: pressure, "
                             "2: vorticity, 3: dye")
    parser.add_argument("-vc", "--vorticity_confinement", type=float, default=unset,
                        help="Vorticity confinement weight (default 5.0); 0.0 disables")
    parser.add_argument("-scheme", "--advection_scheme", type=str,
                        choices=["upwind", "kk", "cip"], default=unset,
                        help="Advection scheme (default cip)")
    parser.add_argument("-no_dye", "--no_dye", action="store_true", default=unset,
                        help="Disable dye transport")
    parser.add_argument("-cpu", "--cpu", action="store_true",
                        help="Force the CPU backend")
    # --- additions over the reference (headless operation) --------------
    parser.add_argument("--steps", type=int, default=1000,
                        help="Number of simulation steps to run")
    parser.add_argument("--frame-every", type=int, default=0,
                        help="Write a PNG frame every N steps (0 = off); "
                             "the reference renders every 5th step")
    parser.add_argument("--gif", type=str, default="",
                        help="Also collect the frames into an animated GIF here")
    parser.add_argument("--output", type=str, default="output",
                        help="Output directory for frames/dumps")
    parser.add_argument("--dump-fields", action="store_true",
                        help="Dump v/p(/dye) .npz at the end (reference 'd' key)")
    parser.add_argument("--checkpoint", type=str, default="",
                        help="Write a full-state checkpoint here at the end")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="Also checkpoint every N steps (requires --checkpoint); "
                             "with --abort-on-nan this gives crash-and-resume safety")
    parser.add_argument("--abort-on-nan", action="store_true",
                        help="Stop (after the last good checkpoint) if fields go NaN")
    parser.add_argument("--resume", type=str, default="",
                        help="Resume from a checkpoint written by --checkpoint")
    parser.add_argument("--pressure-solver", type=str, choices=["sor", "jacobi"],
                        default=argparse.SUPPRESS,
                        help="Pressure Poisson solver (default sor)")
    parser.add_argument("--dtype", type=str, choices=["float32", "bfloat16"],
                        default=argparse.SUPPRESS,
                        help="Transport (device-memory storage) dtype of the state "
                             "fields; arithmetic stays float32. bfloat16 halves "
                             "the bytes each phase moves at one bf16 rounding per "
                             "field per phase (default float32 = reference parity)")
    parser.add_argument("--sor-omega", type=float, default=argparse.SUPPRESS,
                        help="SOR relaxation factor (default 1.3)")
    parser.add_argument("--pressure-iters", type=int, default=argparse.SUPPRESS,
                        help="Pressure iterations per step (default 2)")
    parser.add_argument("--log-every", type=int, default=0,
                        help="Log steps/sec and field diagnostics every N steps")
    parser.add_argument("--shard", type=int, default=0,
                        help="Shard the grid over N devices (0 = single device)")
    parser.add_argument("--shard-mesh", type=str, default="",
                        help="2-D decomposition: NXxNY device mesh (e.g. 4x2); "
                             "GSPMD route only, overrides --shard")
    parser.add_argument("--mask-image", type=str, default=argparse.SUPPRESS,
                        help="Obstacle silhouette: a grayscale image path or a "
                             "bundled asset name (dragon, rabbit, aircraft); "
                             "replaces the -bc scene")
    parser.add_argument("--interactive", action="store_true",
                        help="Open an interactive window (needs a display); "
                             "keys: p pause, v cycle vis, s screenshot, d dump, q quit")
    return parser


def cpu_requested(cpu_flag: bool, *platform_settings: str | None) -> bool:
    """Whether the user asked for the CPU: ``-cpu``, or ``cpu`` first in a
    platform list such as ``jax_platforms`` / ``JAX_PLATFORMS``."""
    return cpu_flag or any(
        s and s.split(",")[0].strip() == "cpu" for s in platform_settings
    )


def resolve_args(args: argparse.Namespace):
    """Fill suppressed (not-typed) flags with their fresh-run defaults and
    return the set of dests the user actually typed."""
    typed = {dest for dest in DEFAULTS if hasattr(args, dest)}
    for dest, value in DEFAULTS.items():
        if dest not in typed:
            setattr(args, dest, value)
    return typed


def main(argv: list[str] | None = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    typed = resolve_args(args)

    def explicit(dest: str) -> bool:
        """Whether the user typed this flag (sentinel-default exact,
        including re-passing a value equal to the default)."""
        return dest in typed

    if args.visualization == 3 and args.no_dye:
        parser.error("-vis 3 (dye) requires dye transport; drop -no_dye")

    import jax

    if args.cpu:
        # Set before any backend is touched, so it wins over the
        # environment's platform list.
        jax.config.update("jax_platforms", "cpu")
    device = jax.devices()[0]
    if device.platform == "cpu" and not cpu_requested(
        args.cpu, jax.config.jax_platforms, os.environ.get("JAX_PLATFORMS")
    ):
        parser.error("no accelerator found, and the CPU was not asked for; "
                     "pass -cpu (or set JAX_PLATFORMS=cpu) to run on the CPU")

    from fluid2d_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np  # deferred: after backend env is settled

    from fluid2d_tpu.config import SimConfig, default_dt
    from fluid2d_tpu.models.simulator import FluidSimulator
    from fluid2d_tpu.scenes.compile import get_scene
    from fluid2d_tpu.utils.io import fields_to_numpy, write_png
    from fluid2d_tpu.utils.metrics import diagnostics
    from fluid2d_tpu.utils.viz import to_image

    dt = args.time_step if args.time_step != 0.0 else None
    vor_eps = args.vorticity_confinement if args.vorticity_confinement != 0.0 else None

    if args.resume:
        # Scene identity and config come from the checkpoint; explicitly
        # passed CLI flags override where that is state-compatible.
        sim = FluidSimulator.load(
            args.resume,
            bc_num=args.boundary_condition,  # None ⇔ not passed
            mask_image=args.mask_image if explicit("mask_image") else None,
        )
        overrides = {}
        if explicit("reynolds_num"):
            overrides["re"] = args.reynolds_num
        if explicit("vorticity_confinement"):
            overrides["vor_eps"] = vor_eps
        if explicit("time_step"):
            overrides["dt"] = args.time_step
        if explicit("sor_omega"):
            overrides["sor_omega"] = args.sor_omega
        if explicit("pressure_iters"):
            overrides["n_pressure_iter"] = args.pressure_iters
        if explicit("pressure_solver"):
            overrides["pressure_solver"] = args.pressure_solver
        if explicit("dtype"):
            overrides["dtype"] = args.dtype  # load re-narrows the state
        for dest, flag in (("advection_scheme", "-scheme"), ("no_dye", "-no_dye"),
                           ("resolution", "-res")):
            if explicit(dest):
                print(f"note: {flag} cannot change on --resume (the checkpointed "
                      f"state's shape/fields depend on it); keeping the stored value")
        if overrides:
            import dataclasses

            sim = FluidSimulator(sim.scene, dataclasses.replace(sim.cfg, **overrides),
                                 state=sim.state, scene_meta=sim.scene_meta)
        if args.visualization == 3 and not sim.cfg.enable_dye:
            parser.error("-vis 3 (dye) but the checkpoint was written without dye")
    else:
        cfg = SimConfig.create(
            resolution=args.resolution,
            dt=dt,
            re=args.reynolds_num,
            scheme=args.advection_scheme,
            vor_eps=vor_eps,
            enable_dye=not args.no_dye,
            pressure_solver=args.pressure_solver,
            sor_omega=args.sor_omega,
            n_pressure_iter=args.pressure_iters,
            dtype=args.dtype,
        )
        bc_num = args.boundary_condition if args.boundary_condition is not None else 1
        scene = get_scene(bc_num, args.resolution,
                          mask_image=args.mask_image or None)
        sim = FluidSimulator(
            scene, cfg,
            scene_meta={"bc_num": bc_num,
                        "mask_image": args.mask_image or None},
        )

    if args.shard_mesh:
        from fluid2d_tpu.parallel.sharding import shard_simulator

        try:
            nx, ny = (int(v) for v in args.shard_mesh.lower().split("x"))
        except ValueError:
            nx = ny = 0
        if nx < 1 or ny < 1:
            parser.error("--shard-mesh expects NXxNY with positive ints, e.g. 4x2")
        shard_simulator(sim, mesh_shape=(nx, ny))
    elif args.shard:
        from fluid2d_tpu.parallel.sharding import shard_simulator

        shard_simulator(sim, args.shard)

    cfg = sim.cfg
    # Report the scene actually in effect (on --resume the checkpoint's
    # stored identity, not the argparse default).
    scene_desc = sim.scene_meta.get("mask_image") or sim.scene_meta.get(
        "bc_num", args.boundary_condition
    )
    print(
        f"Device: {device.platform} {device.device_kind} x{len(jax.devices())}\n"
        f"Boundary Condition: {scene_desc}\ndt: {cfg.dt}\nRe: {cfg.re}\n"
        f"Resolution: {cfg.resolution}\nScheme: {cfg.scheme}\n"
        f"Vorticity confinement: {cfg.vor_eps}"
    )

    if args.interactive:
        from fluid2d_tpu.utils.viewer import run_viewer

        run_viewer(sim, vis=args.visualization, output_dir=args.output,
                   max_steps=args.steps or None)
        return

    if args.gif and not args.frame_every:
        print("note: --gif needs --frame-every to collect frames; no GIF will be written")

    out_dir = Path(args.output)
    # Each periodic action fires exactly at multiples of ITS interval:
    # every chunk ends at the nearest upcoming due-point of any action.
    intervals = [v for v in (args.frame_every, args.log_every,
                             args.checkpoint_every if args.checkpoint else 0) if v]
    done = 0
    frame_idx = 0
    gif_paths: list[Path] = []  # frame FILES — the GIF streams from disk
    aborted = False
    t0 = time.perf_counter()
    while done < args.steps:
        stop = min([args.steps] + [done - done % v + v for v in intervals])
        sim.step(stop - done)
        done = stop
        if args.abort_on_nan:
            from fluid2d_tpu.utils.metrics import has_nan

            if has_nan(sim.state):
                print(f"** NaN detected at step {sim.step_count}; aborting "
                      f"(resume from the last checkpoint with --resume)")
                aborted = True
                break
        if args.checkpoint_every and args.checkpoint and done % args.checkpoint_every == 0:
            sim.save(args.checkpoint)
        if args.frame_every and done % args.frame_every == 0:
            frame = to_image(sim._render(sim.state, sim.scene, args.visualization))
            frame_path = out_dir / f"frame_{frame_idx:05d}.png"
            write_png(frame_path, frame)
            if args.gif:
                gif_paths.append(frame_path)
            frame_idx += 1
        if args.log_every and done % args.log_every == 0:
            elapsed = time.perf_counter() - t0
            diag = diagnostics(sim.state, sim.scene, cfg)
            print(f"step {sim.step_count}: {done / elapsed:8.1f} steps/s  {diag}")

    elapsed = time.perf_counter() - t0
    np.asarray(sim.state.v)  # sync
    print(f"ran {done} steps in {elapsed:.2f}s ({done / elapsed:.1f} steps/s)")

    if args.dump_fields:
        out_dir.mkdir(parents=True, exist_ok=True)
        np.savez(out_dir / f"step_{sim.step_count:06d}.npz", **fields_to_numpy(sim.state))
        print(f"dumped fields to {out_dir}")
    if args.gif and gif_paths:
        from fluid2d_tpu.utils.io import write_gif

        write_gif(args.gif, gif_paths)
        print(f"animation written to {args.gif} ({len(gif_paths)} frames)")
    if args.checkpoint and not aborted:
        # After a NaN abort the final state is garbage — keep the last
        # good periodic checkpoint instead of overwriting it.
        sim.save(args.checkpoint)
        print(f"checkpoint written to {args.checkpoint}")


if __name__ == "__main__":
    main()
