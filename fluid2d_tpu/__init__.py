"""fluid2d_tpu — a 2D incompressible Navier-Stokes framework in JAX.

A from-scratch JAX/XLA re-design with the full capability surface
of takah29/2d-fluid-simulator (MAC fractional-step solver; upwind /
Kawamura-Kuwahara / CIP advection; Jacobi & red-black SOR pressure
solvers; six boundary-condition scenes incl. image-mask obstacles;
vorticity confinement; passive RGB dye transport; four visualizations),
plus accelerator infrastructure: whole-step jit + ``lax.scan`` time
loops, grid sharding over device meshes with halo exchange,
checkpoint/resume, and benchmarking.
"""

from fluid2d_tpu.config import SimConfig, default_dt
from fluid2d_tpu.models.simulator import FluidSimulator, make_run_fn, make_step_fn
from fluid2d_tpu.scenes.compile import Scene, compile_scene, get_scene
from fluid2d_tpu.state import SimState, init_state

__version__ = "0.1.0"

__all__ = [
    "FluidSimulator",
    "Scene",
    "SimConfig",
    "SimState",
    "compile_scene",
    "default_dt",
    "get_scene",
    "init_state",
    "make_run_fn",
    "make_step_fn",
]
