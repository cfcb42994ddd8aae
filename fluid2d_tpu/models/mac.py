"""MAC fractional-step solver with upwind / Kawamura-Kuwahara advection.

Functional re-design of the reference's ``MacSolver`` / ``DyeMacSolver``
(``/root/reference/fs/solver.py:53-162``): the whole time step is one
fused dataflow — BC re-imposition, the momentum update
``v += dt·(−(v·∇)v − ∇p + ∇²v/Re)``, optional vorticity confinement, the
pressure Poisson iterations, the velocity limiter, and (dye mode) passive
dye advection — compiled by XLA into a handful of fused stencil passes.

Buffer-staleness parity: masked updates write ``where(mask, new, alt)``
so non-updated cells carry the alternate buffer's stale values exactly
like the reference's swap scheme (see ``docs/PARITY.md``).
"""

from __future__ import annotations

import jax.numpy as jnp

from fluid2d_tpu.config import SimConfig
from fluid2d_tpu.models.common import (
    confinement,
    laplacian,
    pressure_gradient,
    update_pressure_and_limit,
)
from fluid2d_tpu.ops.advection import advect_kk, advect_upwind
from fluid2d_tpu.ops.limiters import clamp_field
from fluid2d_tpu.scenes.compile import Scene
from fluid2d_tpu.scenes.runtime_bc import dye_bc, velocity_bc
from fluid2d_tpu.state import SimState
from fluid2d_tpu.utils.dtypes import f32

__all__ = ["mac_step", "mac_velocity_phase", "mac_dye_phase"]

_ADVECT = {"upwind": advect_upwind, "kk": advect_kk}


def mac_velocity_phase(state: SimState, scene: Scene, cfg: SimConfig):
    """Velocity BC on the current buffer, then the fused momentum update
    writes fluid cells of the alternate buffer; swap. Returns
    ``(v, v_alt)``. Transport dtype: upcast on load, round once at the
    outputs (utils/dtypes.py)."""
    advect = _ADVECT[cfg.scheme]
    dt, dx = cfg.dt, cfg.dx
    sd = state.v.dtype
    vc = velocity_bc(f32(state.v), scene)
    rhs = (
        -advect(vc[0], vc[1], vc, dx)
        - pressure_gradient(f32(state.p), dx)
        + laplacian(vc, dx) / cfg.re
    )
    v_cur = jnp.where(scene.fluid, vc + dt * rhs, f32(state.v_alt))
    return v_cur.astype(sd), vc.astype(sd)


def mac_dye_phase(state: SimState, v, scene: Scene, cfg: SimConfig):
    """Pure advection of the dye by the limited velocity `v`, then a
    global clamp to [0, 1] on the current buffer only. Returns
    ``(dye, dye_alt)``."""
    advect = _ADVECT[cfg.scheme]
    sd = state.dye.dtype
    dc = dye_bc(f32(state.dye), scene)
    vel = f32(v)
    dn = dc - cfg.dt * advect(vel[0], vel[1], dc, cfg.dx)
    dye_cur = clamp_field(jnp.where(scene.fluid, dn, f32(state.dye_alt)), 0.0, 1.0)
    return dye_cur.astype(sd), dc.astype(sd)


def mac_step(state: SimState, scene: Scene, cfg: SimConfig) -> SimState:
    """One MAC time step (``MacSolver.update``, ``fs/solver.py:79-89``;
    dye tail: ``DyeMacSolver.update``, ``:136-152``)."""
    v_cur, v_alt = mac_velocity_phase(state, scene, cfg)

    if cfg.vor_eps is not None:
        v_cur, v_alt = confinement(v_cur, v_alt, scene, cfg)

    p_cur, p_alt, v_cur = update_pressure_and_limit(state.p, state.p_alt, v_cur, scene, cfg)

    kw = dict(step=state.step + 1, v=v_cur, v_alt=v_alt, p=p_cur, p_alt=p_alt)

    if cfg.enable_dye:
        dye_cur, dc = mac_dye_phase(state, v_cur, scene, cfg)
        kw.update(dye=dye_cur, dye_alt=dc)

    return state._replace(**kw)
