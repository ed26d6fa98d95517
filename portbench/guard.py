"""The run's check that nothing it ran loaded JAX or the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "visualslam_tpu")


def forbidden_modules(modules=None) -> list:
    """Top-level names in sys.modules (the part before the first dot,
    compared whole) that are JAX's or the JAX package's."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                           else modules)}
    return sorted(names.intersection(FORBIDDEN))
