"""Full-array advection schemes (central, 1st-order upwind, Kawamura-Kuwahara).

Full-array re-design of the reference's per-cell advection device functions
(``/root/reference/fs/advection.py:7-60``): each scheme computes the
advection term ``(v·∇)φ`` for the whole grid at once. Upwinding branches
become ``jnp.where`` selects between pre-shifted difference arrays, which
XLA fuses into one elementwise pass — no per-cell control flow.

Shapes: velocity components ``u, w`` are ``(X, Y)``; the advected field
``phi`` is ``(..., X, Y)`` (leading channel axes broadcast). Returns the
advection term with phi's shape.

CIP advection is *not* here (matching the reference layering): it
co-advects gradients and lives in :mod:`fluid2d_tpu.ops.cip`.
"""

from __future__ import annotations

import jax.numpy as jnp

from fluid2d_tpu.ops.stencil import (
    bdiff_x,
    bdiff_y,
    diff_x,
    diff_y,
    fdiff_x,
    fdiff_y,
    shift_x,
    shift_y,
)

__all__ = ["advect_central", "advect_upwind", "advect_kk"]


def advect_central(u, w, phi, dx: float):
    """Central differencing, ``fs/advection.py:7-9`` (unused by the
    reference CLI but part of its library surface — kept for parity)."""
    return u * diff_x(phi, dx) + w * diff_y(phi, dx)


def advect_upwind(u, w, phi, dx: float):
    """First-order upwind differencing (``fs/advection.py:13-24``).

    The reference picks the forward difference at ``i`` when ``u < 0``
    and at ``i-1`` otherwise; the latter equals the backward difference
    at ``i``. NaN velocity compares false → backward branch (parity with
    Taichi's ``if vc.x < 0.0``).
    """
    ax = u * jnp.where(u < 0.0, fdiff_x(phi, dx), bdiff_x(phi, dx))
    ay = w * jnp.where(w < 0.0, fdiff_y(phi, dx), bdiff_y(phi, dx))
    return ax + ay


def advect_kk(u, w, phi, dx: float):
    """Kawamura-Kuwahara 5-point upwind-biased scheme
    (``fs/advection.py:28-60``).

    coef = [-2, 10, -9, 2, -1] applied to [φ(+2), φ(+1), φ(0), φ(-1), φ(-2)]
    when the carrying velocity is negative; the sign-flipped reversal
    otherwise. Denominator 6·dx.
    """
    p2x, p1x = shift_x(phi, 2), shift_x(phi, 1)
    m1x, m2x = shift_x(phi, -1), shift_x(phi, -2)
    neg_x = -2.0 * p2x + 10.0 * p1x - 9.0 * phi + 2.0 * m1x - 1.0 * m2x
    pos_x = 1.0 * p2x - 2.0 * p1x + 9.0 * phi - 10.0 * m1x + 2.0 * m2x
    a = jnp.where(u < 0.0, neg_x, pos_x) / (6.0 * dx)

    p2y, p1y = shift_y(phi, 2), shift_y(phi, 1)
    m1y, m2y = shift_y(phi, -1), shift_y(phi, -2)
    neg_y = -2.0 * p2y + 10.0 * p1y - 9.0 * phi + 2.0 * m1y - 1.0 * m2y
    pos_y = 1.0 * p2y - 2.0 * p1y + 9.0 * phi - 10.0 * m1y + 2.0 * m2y
    b = jnp.where(w < 0.0, neg_y, pos_y) / (6.0 * dx)

    return u * a + w * b
