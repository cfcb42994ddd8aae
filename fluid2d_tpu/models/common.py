"""Shared pieces of the time-step models (pressure solve, velocity
limiter, vorticity confinement, momentum RHS)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fluid2d_tpu.config import SimConfig
from fluid2d_tpu.ops.limiters import limit_vector_norm
from fluid2d_tpu.ops.pressure import jacobi_pressure_iteration, sor_pressure_iteration
from fluid2d_tpu.ops.stencil import diff2_x, diff2_y, diff_x, diff_y
from fluid2d_tpu.ops.vorticity import apply_confinement
from fluid2d_tpu.scenes.compile import Scene
from fluid2d_tpu.utils.dtypes import f32

__all__ = [
    "update_pressure",
    "update_pressure_and_limit",
    "confinement",
    "pressure_gradient",
    "laplacian",
]


def pressure_gradient(p, dx: float):
    """(∂p/∂x, ∂p/∂y) stacked to (2, X, Y)."""
    return jnp.stack([diff_x(p, dx), diff_y(p, dx)])


def laplacian(f, dx: float):
    """∇²f with the reference's paired stencils (``fs/solver.py:106,263-265``)."""
    return diff2_x(f, dx) + diff2_y(f, dx)


def update_pressure(p_cur, p_alt, v, scene: Scene, cfg: SimConfig):
    """n_iter pressure iterations with the configured solver
    (``fs/pressure_updater.py:56-60,86-90``). Returns the new
    ``(p_cur, p_alt)`` pair."""
    if cfg.n_pressure_iter <= 0:
        return p_cur, p_alt
    # Arithmetic in f32 regardless of the transport dtype; round back
    # once after the iterations (utils/dtypes.py).
    sd = p_cur.dtype
    u32, w32 = f32(v[0]), f32(v[1])
    if cfg.pressure_solver == "sor":
        def one(pair, _):
            return sor_pressure_iteration(*pair, u32, w32, scene, cfg.sor_omega,
                                          cfg.dt, cfg.dx), None
    else:
        def one(pair, _):
            return jacobi_pressure_iteration(*pair, u32, w32, scene, cfg.dt, cfg.dx), None

    pair = (f32(p_cur), f32(p_alt))
    if cfg.n_pressure_iter <= 4:
        for _ in range(cfg.n_pressure_iter):
            pair, _ = one(pair, None)
    else:
        pair, _ = jax.lax.scan(one, pair, None, length=cfg.n_pressure_iter)
    return pair[0].astype(sd), pair[1].astype(sd)


def update_pressure_and_limit(p_cur, p_alt, v, scene: Scene, cfg: SimConfig):
    """Pressure iterations + the velocity-norm limiter
    (``fs/solver.py:87-89``: all iterations read the same pre-limit v;
    the limiter applies after). Returns ``(p_cur, p_alt, v_limited)``."""
    p_cur, p_alt = update_pressure(p_cur, p_alt, v, scene, cfg)
    v_lim = limit_vector_norm(f32(v), cfg.velocity_limit).astype(v.dtype)
    return p_cur, p_alt, v_lim


def confinement(v_cur, v_alt, scene: Scene, cfg: SimConfig):
    """Vorticity confinement + swap (``fs/solver.py:84-86``). Returns the
    new ``(v_cur, v_alt)`` pair."""
    vn, _ = apply_confinement(
        f32(v_cur), f32(v_alt), scene.fluid, cfg.dt, cfg.vor_eps, cfg.dx
    )
    # After the swap the alternate is the pre-confinement current: only
    # the fluid-updated buffer is a fresh store.
    return vn.astype(v_cur.dtype), v_cur
