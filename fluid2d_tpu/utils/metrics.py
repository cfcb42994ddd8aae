"""Run-time diagnostics and observability.

The reference logs a single startup print (``main.py:71-74``); a
headless production run needs per-interval health metrics: velocity
divergence (what the pressure solve is driving down), max speed
(the limiter's input), pressure residual scale, and NaN detection.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fluid2d_tpu.ops.stencil import diff_x, diff_y

__all__ = ["divergence", "diagnostics", "has_nan"]


def divergence(v, dx: float):
    """∇·v on the collocated grid (central differences)."""
    return diff_x(v[0], dx) + diff_y(v[1], dx)


@jax.jit
def _diag_arrays(v, p, fluid, dx):
    v = v.astype(jnp.float32)  # diagnostics in f32 whatever the transport dtype
    p = p.astype(jnp.float32)
    div = jnp.where(fluid, divergence(v, dx), 0.0)
    speed = jnp.sqrt(v[0] ** 2 + v[1] ** 2)
    n_fluid = jnp.maximum(fluid.sum(), 1)
    return (
        jnp.sqrt((div**2).sum() / n_fluid),  # RMS divergence over fluid
        speed.max(),
        jnp.abs(p).max(),
        jnp.isnan(v).any() | jnp.isnan(p).any(),
    )


def diagnostics(state, scene, cfg) -> str:
    div_rms, vmax, pmax, nan = _diag_arrays(state.v, state.p, scene.fluid, cfg.dx)
    s = f"div_rms={float(div_rms):.3e} max|v|={float(vmax):.3f} max|p|={float(pmax):.3e}"
    if bool(nan):
        s += "  ** NaN DETECTED **"
    return s


def has_nan(state) -> bool:
    """NaN guard over the primary fields (cheap device-side reduction)."""
    leaves = [state.v, state.p] + ([state.dye] if state.dye is not None else [])
    return bool(jnp.array([jnp.isnan(x).any() for x in leaves]).any())
