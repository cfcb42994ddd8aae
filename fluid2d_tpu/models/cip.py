"""CIP MAC solver: two-phase update with gradient co-advection.

Functional re-design of the reference's ``CipMacSolver`` /
``DyeCipMacSolver`` (``/root/reference/fs/solver.py:165-401``). Phase
structure per step:

1. non-advection: pressure + diffusion applied at not-wall cells
   (inflow/outflow included, unlike the advection phase);
2. gradient update from the non-advection *change*;
3. (buffers swap) cubic CIP advection of value+gradients at fluid cells;
4. optional vorticity confinement, pressure Poisson solve, velocity limit;
5. dye mode: the same two-phase structure on the 3-channel dye
   (diffusion-only non-advection phase — dye diffuses with the same Re).

Domain predicates differ deliberately between phases (not-wall vs fluid),
matching ``fs/solver.py:233,254,279`` vs ``:97,160``.
"""

from __future__ import annotations

import jax.numpy as jnp

from fluid2d_tpu.config import SimConfig
from fluid2d_tpu.models.common import confinement, update_pressure_and_limit
from fluid2d_tpu.ops.cip import (
    cip_advect,
    non_advection_diffusion,
    non_advection_grad,
    non_advection_velocity,
)
from fluid2d_tpu.ops.limiters import clamp_field
from fluid2d_tpu.scenes.compile import Scene
from fluid2d_tpu.scenes.runtime_bc import dye_bc, velocity_bc
from fluid2d_tpu.state import SimState
from fluid2d_tpu.utils.dtypes import f32

__all__ = ["cip_step", "cip_velocity_phase", "cip_dye_phase"]


def _advect_phase(f_na, gx_na, gy_na, vel, alt_f, alt_gx, alt_gy, scene, cfg):
    """CIP advection at fluid cells, non-fluid from the alternate buffer."""
    f_cand, gx_cand, gy_cand = cip_advect(f_na, gx_na, gy_na, vel[0], vel[1], cfg.dt, cfg.dx)
    fl = scene.fluid
    return (
        jnp.where(fl, f_cand, alt_f),
        jnp.where(fl, gx_cand, alt_gx),
        jnp.where(fl, gy_cand, alt_gy),
    )


def cip_velocity_phase(state: SimState, scene: Scene, cfg: SimConfig):
    """BC → non-advection → gradient update → CIP advection of the
    velocity family. Returns ``(v, vx, vy, v_alt, vx_alt, vy_alt)``.

    Transport dtype: upcast on load, round once at the six outputs
    (utils/dtypes.py)."""
    dt, dx = cfg.dt, cfg.dx
    nw = scene.not_wall
    sd = state.v.dtype
    vc = velocity_bc(f32(state.v), scene)

    # Non-advection (pressure + diffusion) into the alt buffer.
    v_na = jnp.where(
        nw, non_advection_velocity(vc, f32(state.p), cfg.re, dt, dx), f32(state.v_alt)
    )
    gx_cand, gy_cand = non_advection_grad(f32(state.vx), f32(state.vy), vc, v_na, dx)
    vx_na = jnp.where(nw, gx_cand, f32(state.vx_alt))
    vy_na = jnp.where(nw, gy_cand, f32(state.vy_alt))
    # (swap: current = *_na, next = pre-phase current)

    # CIP advection at fluid cells, carried by the non-advected
    # velocity; non-fluid cells of the write buffer keep the pre-phase
    # values (vc for v — BC-fresh inflow/outflow survive).
    v_cur, vx_cur, vy_cur = _advect_phase(
        v_na, vx_na, vy_na, v_na, vc, f32(state.vx), f32(state.vy), scene, cfg
    )
    return tuple(a.astype(sd) for a in (v_cur, vx_cur, vy_cur, v_na, vx_na, vy_na))


def cip_dye_phase(state: SimState, v, scene: Scene, cfg: SimConfig):
    """The same two-phase CIP update on the 3-channel dye, carried by the
    limited velocity `v`, then the [0, 1] clamp. Returns
    ``(dye, dyex, dyey, dye_alt, dyex_alt, dyey_alt)``."""
    dt, dx = cfg.dt, cfg.dx
    nw = scene.not_wall
    sd = state.dye.dtype
    dc = dye_bc(f32(state.dye), scene)
    d_na = jnp.where(nw, non_advection_diffusion(dc, cfg.re, dt, dx), f32(state.dye_alt))
    dgx_cand, dgy_cand = non_advection_grad(f32(state.dyex), f32(state.dyey), dc, d_na, dx)
    dx_na = jnp.where(nw, dgx_cand, f32(state.dyex_alt))
    dy_na = jnp.where(nw, dgy_cand, f32(state.dyey_alt))

    dye_adv, dyex_cur, dyey_cur = _advect_phase(
        d_na, dx_na, dy_na, f32(v), dc, f32(state.dyex), f32(state.dyey), scene, cfg
    )
    dye_cur = clamp_field(dye_adv, 0.0, 1.0)
    return tuple(a.astype(sd) for a in (dye_cur, dyex_cur, dyey_cur, d_na, dx_na, dy_na))


def cip_step(state: SimState, scene: Scene, cfg: SimConfig) -> SimState:
    """One CIP time step (``CipMacSolver.update``, ``fs/solver.py:192-202``;
    dye tail: ``DyeCipMacSolver.update``, ``:353-373``)."""
    v_cur, vx_cur, vy_cur, v_alt, vx_alt, vy_alt = cip_velocity_phase(state, scene, cfg)

    if cfg.vor_eps is not None:
        v_cur, v_alt = confinement(v_cur, v_alt, scene, cfg)

    p_cur, p_alt, v_cur = update_pressure_and_limit(state.p, state.p_alt, v_cur, scene, cfg)

    kw = dict(
        step=state.step + 1,
        v=v_cur,
        v_alt=v_alt,
        vx=vx_cur,
        vx_alt=vx_alt,
        vy=vy_cur,
        vy_alt=vy_alt,
        p=p_cur,
        p_alt=p_alt,
    )

    if cfg.enable_dye:
        dye_cur, dyex_cur, dyey_cur, d_na, dx_na, dy_na = cip_dye_phase(
            state, v_cur, scene, cfg
        )
        kw.update(
            dye=dye_cur,
            dye_alt=d_na,
            dyex=dyex_cur,
            dyex_alt=dx_na,
            dyey=dyey_cur,
            dyey_alt=dy_na,
        )

    return state._replace(**kw)
