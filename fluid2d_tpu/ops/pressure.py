"""Pressure Poisson iteration operators (Jacobi and red-black SOR).

Full-array re-design of ``/root/reference/fs/pressure_updater.py``. The
reference's double-buffer dance has observable staleness semantics that we
reproduce exactly in functional form (required for ≤1e-5 RMS parity):

* Each iteration applies the pressure BC to the *current* buffer, then the
  sweeps write into the *alternate* buffer — whose non-swept cells (walls,
  inflow/outflow, and for SOR the pre-sweep even-parity values) retain
  values from one iteration earlier. The buffers then swap.
* The SOR even sweep reads the same buffer it writes (true Gauss-Seidel
  coloring, ``fs/pressure_updater.py:92-96``): even cells see the odd
  sweep's fresh neighbors but their *own* stale value in the relaxation
  term, plus stale even values through clamp-to-edge self-reads at grid
  borders.

Functionally this is just two masked full-array updates on an explicit
``(p_cur, p_alt)`` pair — no races possible, same dataflow.
"""

from __future__ import annotations

import jax.numpy as jnp

from fluid2d_tpu.ops.stencil import shift_x, shift_y

__all__ = ["predict_p", "sor_pressure_iteration", "jacobi_pressure_iteration"]


def predict_p(p, u, w, dt: float, dx: float):
    """Jacobi/SOR pressure prediction (``fs/pressure_updater.py:24-38``).

    ¼·(4-neighbor sum) + nonlinear velocity-gradient source − divergence
    forcing, all with clamp-to-edge sampling.
    """
    sub_x_u = shift_x(u, 1) - shift_x(u, -1)  # Δx u
    sub_x_w = shift_x(w, 1) - shift_x(w, -1)  # Δx w
    sub_y_u = shift_y(u, 1) - shift_y(u, -1)  # Δy u
    sub_y_w = shift_y(w, 1) - shift_y(w, -1)  # Δy w

    return (
        0.25 * (shift_x(p, 1) + shift_x(p, -1) + shift_y(p, 1) + shift_y(p, -1))
        + (sub_x_u**2 + sub_y_w**2 + (sub_y_u * sub_x_w)) / 8.0
        - dx * (sub_x_u + sub_y_w) / (8 * dt)
    )


def sor_pressure_iteration(p_cur, p_alt, u, w, scene, omega: float, dt: float, dx: float):
    """One red-black SOR iteration with exact reference buffer semantics
    (``fs/pressure_updater.py:86-114``).

    Returns the new ``(p_cur, p_alt)`` pair (post-swap order).
    """
    from fluid2d_tpu.scenes.runtime_bc import pressure_bc  # local import: avoid cycle

    pc = pressure_bc(p_cur, scene)
    # Odd sweep: read BC'd current, write into alternate buffer.
    pn = jnp.where(scene.odd_fluid, (1.0 - omega) * pc + omega * predict_p(pc, u, w, dt, dx), p_alt)
    # Even sweep: read AND write the same buffer (Gauss-Seidel coloring).
    pn = jnp.where(scene.even_fluid, (1.0 - omega) * pn + omega * predict_p(pn, u, w, dt, dx), pn)
    return pn, pc


def jacobi_pressure_iteration(p_cur, p_alt, u, w, scene, dt: float, dx: float):
    """One Jacobi iteration (``fs/pressure_updater.py:42-66``; unused by the
    reference factory but part of its library surface). Writes all
    non-wall cells of the alternate buffer; returns post-swap pair."""
    from fluid2d_tpu.scenes.runtime_bc import pressure_bc

    pc = pressure_bc(p_cur, scene)
    pn = jnp.where(scene.not_wall, predict_p(pc, u, w, dt, dx), p_alt)
    return pn, pc
