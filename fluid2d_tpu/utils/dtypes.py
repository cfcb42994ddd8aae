"""Transport-dtype helpers.

``SimConfig.dtype`` is the *transport* (device-memory storage) dtype of
the state fields; all arithmetic stays float32 regardless. A
``bfloat16`` transport mode halves the bytes every phase reads and
writes at the cost of one bf16 rounding per field per phase store.
These helpers centralize the two conversions so every phase rounds at
the same points: upcast on load (:func:`f32`), round once at the
phase-output store (:func:`to_transport`).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["f32", "to_transport"]

_REDUCED = (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16))


def f32(x):
    """Upcast a reduced-precision transport array to float32 for
    arithmetic (identity for float32 / integer arrays)."""
    return x.astype(jnp.float32) if x.dtype in _REDUCED else x


def to_transport(x, dtype):
    """Round a computed (float32) array to the transport dtype (identity
    when they already match)."""
    return x.astype(dtype) if x.dtype != jnp.dtype(dtype) else x
