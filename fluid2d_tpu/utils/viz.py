"""Field → RGB visualizations.

Parity targets: ``/root/reference/fs/visualization.py`` (colormaps) and
the scale factors / wall color baked into the simulator's render kernels
(``fs/fluid_simulator.py:16-17,38-58,121-126``). On headless hosts there is no
GUI; frames are computed on device as (X, Y, 3) float32 and downloaded
for PNG/video writing (see :mod:`fluid2d_tpu.utils.io`).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from fluid2d_tpu.ops.stencil import diff_x, diff_y

__all__ = [
    "WALL_COLOR",
    "visualize_norm",
    "visualize_pressure",
    "visualize_vorticity",
    "visualize_xy",
    "visualize_hue",
    "render_rgb",
    "VIS_MODES",
]

WALL_COLOR = (0.5, 0.7, 0.5)  # fs/fluid_simulator.py:17


def _stack3(r, g, b):
    return jnp.stack([r, g, b], axis=-1)


def visualize_norm(v):
    """Grayscale ‖v‖ (``fs/visualization.py:9-11``); v is (2, X, Y) →
    (X, Y, 3)."""
    c = jnp.sqrt(v[0] ** 2 + v[1] ** 2)
    return _stack3(c, c, c)


def visualize_pressure(p):
    """Red = +p, blue = −p (``fs/visualization.py:15-16``)."""
    zero = jnp.zeros_like(p)
    return _stack3(jnp.maximum(p, 0.0), zero, jnp.maximum(-p, 0.0))


def visualize_vorticity(v, dx: float):
    """Red/blue curl (``fs/visualization.py:20-22``)."""
    curl = diff_x(v[1], dx) - diff_y(v[0], dx)
    zero = jnp.zeros_like(curl)
    return _stack3(jnp.maximum(curl, 0.0), zero, jnp.maximum(-curl, 0.0))


def visualize_xy(v):
    """(y, 0, x) channel map (``fs/visualization.py:55-56``; unused by the
    reference CLI, kept for library parity)."""
    zero = jnp.zeros_like(v[0])
    return _stack3(v[1], zero, v[0])


def visualize_hue(v):
    """Direction→hue, log-banded magnitude→saturation/value
    (``fs/visualization.py:26-51``; unused by the reference CLI, kept for
    library parity). v is (2, X, Y) → (X, Y, 3)."""
    h = jnp.arctan2(v[1], v[0])
    h = jnp.where(h < 0, h + 2 * math.pi, h) / (2 * math.pi)

    m = jnp.sqrt(v[0] ** 2 + v[1] ** 2)
    # The reference expands the band [ranges, rangee) by factors of e until
    # it contains m (:37-39); closed form: n = ceil(ln(m/10)) clamped to ≥0.
    n = jnp.where(m > 10.0, jnp.ceil(jnp.log(m / 10.0)), 0.0)
    rangee = 10.0 * jnp.exp(n)
    ranges = jnp.where(n == 0.0, 0.0, 10.0 * jnp.exp(n - 1.0))
    k = (m - ranges) / (rangee - ranges)

    tri = jnp.where(k < 0.5, k * 2.0, 1.0 - (k - 0.5) * 2.0)
    s = 1.0 - (1.0 - tri) ** 3
    s = 0.4 + s * 0.6
    val = 1.0 - tri
    val = 1.0 - (1.0 - val) ** 3
    val = 0.6 + val * 0.4
    return _hsv_to_rgb(h, s, val)


def _hsv_to_rgb(h, s, v):
    """Branch-free HSV→RGB (parity: ``fs/visualization.py:60-97``)."""
    h = jnp.where(h == 1.0, 0.0, h)
    z = jnp.floor(h * 6.0)
    i = z.astype(jnp.int32)
    f = h * 6.0 - z
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))

    sel = lambda a0, a1, a2, a3, a4, a5: jnp.select(  # noqa: E731
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [a0, a1, a2, a3, a4, a5],
        jnp.ones_like(v),
    )
    return _stack3(sel(v, q, p, p, t, v), sel(t, v, v, q, p, p), sel(p, p, t, v, v, q))


VIS_MODES = ("norm", "pressure", "vorticity", "dye")


def render_rgb(state, scene, cfg, vis: int | str = 0):
    """Device-side frame render matching ``fs/fluid_simulator.py:38-58,121-126``:
    vis 0 = 0.2·norm + 0.002·pressure, 1 = 0.04·pressure, 2 = 0.005·vorticity,
    3 = raw dye; walls painted (0.5, 0.7, 0.5). Returns (X, Y, 3) float32."""
    if isinstance(vis, str):
        vis = VIS_MODES.index(vis)
    # Render in f32 whatever the transport dtype (one upcast per frame).
    state = state._replace(
        v=state.v.astype(jnp.float32),
        p=state.p.astype(jnp.float32),
        **({"dye": state.dye.astype(jnp.float32)} if state.dye is not None else {}),
    )
    if vis == 0:
        rgb = 0.2 * visualize_norm(state.v) + 0.002 * visualize_pressure(state.p)
    elif vis == 1:
        rgb = 0.04 * visualize_pressure(state.p)
    elif vis == 2:
        rgb = 0.005 * visualize_vorticity(state.v, cfg.dx)
    elif vis == 3:
        if state.dye is None:
            msg = "dye visualization requires enable_dye=True"
            raise ValueError(msg)
        rgb = jnp.moveaxis(state.dye, 0, -1)
    else:
        msg = f"Unknown visualization mode: {vis}"
        raise ValueError(msg)
    wall = scene.wall[..., None]
    return jnp.where(wall, jnp.asarray(WALL_COLOR, jnp.float32), rgb)


def to_image(rgb) -> np.ndarray:
    """(X, Y, 3) float frame → uint8 H×W×3 image in screen orientation
    (y up → row 0 at top, x to the right)."""
    arr = np.asarray(rgb)
    arr = np.clip(arr, 0.0, 1.0)
    arr = np.flip(arr.transpose(1, 0, 2), axis=0)  # (Y, X, 3), top row = max y
    return (arr * 255.0 + 0.5).astype(np.uint8)
