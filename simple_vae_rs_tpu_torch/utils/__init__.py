"""Image helpers and the JAX weight bridge."""
