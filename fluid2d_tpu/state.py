"""Simulation state pytree.

The reference's mutable ``DoubleBuffer`` pairs (``fs/double_buffer.py``)
become explicit ``(cur, alt)`` array pairs carried through the functional
step. The alternate buffers are NOT an implementation detail: the
reference's swap scheme leaves observable stale values in the off buffer
(non-fluid cells skipped by masked kernels retain data from one or two
steps earlier, and the SOR even sweep reads them), so bit-faithful parity
requires carrying both. See ``docs/PARITY.md``.

Fields use channel-leading layout ``(C, X, Y)``: each channel is one
contiguous (X, Y) plane, where the reference's (X, Y, C) layout would
interleave a 2- or 3-wide channel axis into every row.

CIP gradient fields are part of the state (and of checkpoints — fixing
the reference's dump gap, ``main.py:129-132`` saves only v/p/dye).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from fluid2d_tpu.config import SimConfig
from fluid2d_tpu.ops.cip import grad_of
from fluid2d_tpu.scenes.compile import Scene

__all__ = ["SimState", "init_state"]


class SimState(NamedTuple):
    """Carried through ``lax.scan``; optional leaves are ``None`` when the
    config disables the corresponding feature (CIP gradients, dye)."""

    step: jnp.ndarray  # () int32 step counter
    v: jnp.ndarray  # (2, X, Y) velocity, current
    v_alt: jnp.ndarray
    p: jnp.ndarray  # (X, Y) pressure, current
    p_alt: jnp.ndarray
    vx: Optional[jnp.ndarray] = None  # (2, X, Y) CIP ∂v/∂x
    vx_alt: Optional[jnp.ndarray] = None
    vy: Optional[jnp.ndarray] = None  # (2, X, Y) CIP ∂v/∂y
    vy_alt: Optional[jnp.ndarray] = None
    dye: Optional[jnp.ndarray] = None  # (3, X, Y)
    dye_alt: Optional[jnp.ndarray] = None
    dyex: Optional[jnp.ndarray] = None  # (3, X, Y) CIP dye gradients
    dyex_alt: Optional[jnp.ndarray] = None
    dyey: Optional[jnp.ndarray] = None
    dyey_alt: Optional[jnp.ndarray] = None


def init_state(scene: Scene, cfg: SimConfig) -> SimState:
    """All-zero initial fields, with CIP gradients initialized from the
    (zero) fields like the reference's ``_set_grad`` (``fs/solver.py:190,351``).

    Arrays are allocated in ``cfg.dtype`` — the transport (device-memory storage)
    dtype; all arithmetic remains float32 regardless (see config.py)."""
    x_res, y_res = scene.shape
    dt = jnp.dtype(cfg.dtype)
    zf = lambda c=None: (  # noqa: E731
        jnp.zeros((x_res, y_res), dt)
        if c is None
        else jnp.zeros((c, x_res, y_res), dt)
    )

    kw = dict(
        step=jnp.int32(0),
        v=zf(2),
        v_alt=zf(2),
        p=zf(),
        p_alt=zf(),
    )
    if cfg.scheme == "cip":
        gx, gy = grad_of(kw["v"], cfg.dx)
        kw.update(vx=gx.astype(dt), vx_alt=zf(2), vy=gy.astype(dt), vy_alt=zf(2))
    if cfg.enable_dye:
        kw.update(dye=zf(3), dye_alt=zf(3))
        if cfg.scheme == "cip":
            dgx, dgy = grad_of(kw["dye"], cfg.dx)
            kw.update(dyex=dgx.astype(dt), dyex_alt=zf(3),
                      dyey=dgy.astype(dt), dyey_alt=zf(3))
    return SimState(**kw)
