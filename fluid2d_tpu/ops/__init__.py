"""Numerical operators: stencils, advection schemes, CIP, pressure,
vorticity confinement, limiters — full-array JAX that XLA fuses."""
