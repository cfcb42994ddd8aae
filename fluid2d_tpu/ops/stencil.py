"""Clamp-to-edge stencil primitives, full-array (vectorized) form.

Full-array re-design of the reference's per-cell device functions
(``/root/reference/fs/differentiation.py:5-60``): instead of scalar
``sample(field, i+d, j)`` calls inside a grid-parallel kernel, every
primitive here is a whole-array operation built from shifted slices, so
XLA can fuse entire stencil expressions into a single pass over memory.

Semantics contract (must match the reference exactly for ≤1e-5 RMS parity):

* Out-of-range reads clamp to the edge (replicate padding), mirroring
  ``sample``'s index clamping (``fs/differentiation.py:6-7``). This is why
  ``jnp.roll`` (wrap) would be wrong at borders.
* Grids are arrays of shape ``(..., X, Y)``; axis -2 is x, axis -1 is y.
  Leading axes (velocity/dye channels) broadcast through unchanged.
* All arithmetic is float32 with the same association order as the
  reference expressions.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "shift_x",
    "shift_y",
    "shift2",
    "sign",
    "tmin",
    "tmax",
    "fdiff_x",
    "fdiff_y",
    "bdiff_x",
    "bdiff_y",
    "diff_x",
    "diff_y",
    "diff2_x",
    "diff2_y",
]


def shift_x(f: jnp.ndarray, d: int) -> jnp.ndarray:
    """out[..., i, j] = f[..., clamp(i + d), j] (clamp-to-edge)."""
    if d == 0:
        return f
    ax = f.ndim - 2
    if d > 0:
        body = f[..., d:, :]
        edge = f[..., -1:, :]
    else:
        body = f[..., :d, :]
        edge = f[..., :1, :]
    pads = [edge] * abs(d)
    parts = [body, *pads] if d > 0 else [*pads, body]
    return jnp.concatenate(parts, axis=ax)


def shift_y(f: jnp.ndarray, d: int) -> jnp.ndarray:
    """out[..., i, j] = f[..., i, clamp(j + d)] (clamp-to-edge)."""
    if d == 0:
        return f
    ax = f.ndim - 1
    if d > 0:
        body = f[..., d:]
        edge = f[..., -1:]
    else:
        body = f[..., :d]
        edge = f[..., :1]
    pads = [edge] * abs(d)
    parts = [body, *pads] if d > 0 else [*pads, body]
    return jnp.concatenate(parts, axis=ax)


def shift2(f: jnp.ndarray, dx_: int, dy_: int) -> jnp.ndarray:
    """out[..., i, j] = f[..., clamp(i + dx_), clamp(j + dy_)]."""
    return shift_y(shift_x(f, dx_), dy_)


def sign(x: jnp.ndarray) -> jnp.ndarray:
    """-1.0 where x < 0 else +1.0 (sign(0) == sign(nan) == +1).

    Mirrors ``fs/differentiation.py:13-14``; NaN compares false so maps to +1.
    """
    return jnp.where(x < 0.0, jnp.float32(-1.0), jnp.float32(1.0))


def tmin(x: jnp.ndarray, c) -> jnp.ndarray:
    """min with fmin NaN semantics: NaN in `x` yields `c`.

    Taichi's ``ti.min`` lowers to fmin (CUDA fminf / LLVM minnum), which
    returns the non-NaN operand; ``jnp.minimum`` propagates NaN instead.
    The distinction is load-bearing in vorticity confinement, where an
    unguarded 0/0 produces NaN that the reference then *clamps to the
    limit* rather than propagating (``fs/vorticity_confinement.py:49,55``).
    `c` must be NaN-free (it is a clamp constant at every call site).
    """
    return jnp.where(jnp.isnan(x), c, jnp.minimum(x, c))


def tmax(x: jnp.ndarray, c) -> jnp.ndarray:
    """max with fmax NaN semantics: NaN in `x` yields `c`. See `tmin`."""
    return jnp.where(jnp.isnan(x), c, jnp.maximum(x, c))


def fdiff_x(f: jnp.ndarray, dx: float) -> jnp.ndarray:
    """Forward difference in x (``fs/differentiation.py:18-20``)."""
    return (shift_x(f, 1) - f) / dx


def fdiff_y(f: jnp.ndarray, dx: float) -> jnp.ndarray:
    """Forward difference in y (``fs/differentiation.py:24-26``)."""
    return (shift_y(f, 1) - f) / dx


def bdiff_x(f: jnp.ndarray, dx: float) -> jnp.ndarray:
    """Backward difference in x (``fs/differentiation.py:30-32``)."""
    return (f - shift_x(f, -1)) / dx


def bdiff_y(f: jnp.ndarray, dx: float) -> jnp.ndarray:
    """Backward difference in y (``fs/differentiation.py:36-38``)."""
    return (f - shift_y(f, -1)) / dx


def diff_x(f: jnp.ndarray, dx: float) -> jnp.ndarray:
    """Central difference in x (``fs/differentiation.py:42-44``)."""
    return 0.5 * (shift_x(f, 1) - shift_x(f, -1)) / dx


def diff_y(f: jnp.ndarray, dx: float) -> jnp.ndarray:
    """Central difference in y (``fs/differentiation.py:48-50``)."""
    return 0.5 * (shift_y(f, 1) - shift_y(f, -1)) / dx


def diff2_x(f: jnp.ndarray, dx: float) -> jnp.ndarray:
    """Second derivative in x (``fs/differentiation.py:54-55``)."""
    return (shift_x(f, 1) - 2.0 * f + shift_x(f, -1)) / dx**2


def diff2_y(f: jnp.ndarray, dx: float) -> jnp.ndarray:
    """Second derivative in y (``fs/differentiation.py:59-60``)."""
    return (shift_y(f, 1) - 2.0 * f + shift_y(f, -1)) / dx**2
