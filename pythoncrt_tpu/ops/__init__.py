"""Device-side effect primitives (JAX/XLA)."""

from . import blur, color, glitch, resize, warp

__all__ = ["blur", "color", "glitch", "resize", "warp"]
