"""Experiment presets of the port (the six configurations of the JAX package)."""
from .presets import PRESETS, get_preset  # noqa: F401
