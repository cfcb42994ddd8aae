"""Simulation configuration.

Promotes every knob the reference exposes (CLI flags, ``main.py:11-51``)
*and* its hardcoded constants (SOR ω=1.3 / n_iter=2,
``fs/fluid_simulator.py:76-78``; velocity limit 10.0, ``fs/solver.py:12``)
to an explicit, hashable config — it is passed as a static argument to
jitted step functions, so every branch (scheme, dye, confinement, solver)
is resolved at trace time with zero runtime cost.
"""

from __future__ import annotations

import dataclasses

__all__ = ["SimConfig", "default_dt", "VELOCITY_LIMIT"]

VELOCITY_LIMIT = 10.0  # fs/solver.py:12


def default_dt(resolution: int) -> float:
    """dt = 0.05 / resolution when unset (``main.py:56``); dx = 1/res, so
    dt/dx = 0.05."""
    return 0.05 / resolution


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation parameters (hashable; safe as a jit static arg)."""

    resolution: int = 400
    dt: float = 0.000125
    dx: float = 0.0025
    re: float = 1_000_000.0
    scheme: str = "cip"  # "upwind" | "kk" | "cip"
    vor_eps: float | None = 5.0  # None disables vorticity confinement
    enable_dye: bool = True
    pressure_solver: str = "sor"  # "sor" | "jacobi"
    sor_omega: float = 1.3
    n_pressure_iter: int = 2
    velocity_limit: float = VELOCITY_LIMIT
    # Transport (device-memory storage) dtype of the state fields. All
    # arithmetic stays float32: each phase upcasts on load and rounds
    # once at its outputs, so "bfloat16" halves the bytes every phase
    # reads and writes at the cost of one bf16 rounding per field per
    # phase. float32 is the reference-parity default.
    dtype: str = "float32"  # "float32" | "bfloat16"

    @staticmethod
    def create(
        resolution: int = 400,
        dt: float | None = None,
        re: float = 1_000_000.0,
        scheme: str = "cip",
        vor_eps: float | None = 5.0,
        enable_dye: bool = True,
        pressure_solver: str = "sor",
        sor_omega: float = 1.3,
        n_pressure_iter: int = 2,
        velocity_limit: float = VELOCITY_LIMIT,
        dtype: str = "float32",
    ) -> "SimConfig":
        """Mirror of the reference CLI's derived parameters
        (``main.py:56,63``): dt defaults to 0.05/res, dx = 1/res,
        vor_eps=0.0 is treated as disabled (``main.py:60-62``)."""
        if scheme not in ("upwind", "kk", "cip"):
            msg = f"Unknown scheme: {scheme}"
            raise ValueError(msg)
        if pressure_solver not in ("sor", "jacobi"):
            msg = f"Unknown pressure solver: {pressure_solver}"
            raise ValueError(msg)
        if dtype not in ("float32", "bfloat16"):
            msg = f"Unknown transport dtype: {dtype}"
            raise ValueError(msg)
        if vor_eps is not None and vor_eps == 0.0:
            vor_eps = None
        return SimConfig(
            resolution=resolution,
            dt=dt if dt else default_dt(resolution),
            dx=1.0 / resolution,
            re=re,
            scheme=scheme,
            vor_eps=vor_eps,
            enable_dye=enable_dye,
            pressure_solver=pressure_solver,
            sor_omega=sor_omega,
            n_pressure_iter=n_pressure_iter,
            velocity_limit=velocity_limit,
            dtype=dtype,
        )
