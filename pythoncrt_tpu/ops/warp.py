"""Barrel-warp bilinear gather (JAX).

The warp's inverse map is static per (H, W, strength), so the host
precomputes the integer floor coordinates and float fractions
(oracle.ops.split_map over oracle.engine.barrel_warp_maps) and the
device does four constant-index gathers with constant-0 out-of-bounds
taps. Replaces cv2.remap at crt_filter.py:347.
"""

from __future__ import annotations

import jax.numpy as jnp


def bilinear_gather_const0(
    img: jnp.ndarray,
    y0: jnp.ndarray,
    x0: jnp.ndarray,
    fy: jnp.ndarray,
    fx: jnp.ndarray,
) -> jnp.ndarray:
    """Sample (H, W, C) ``img`` at quantized coordinates.

    y0/x0: int32 (H, W) floor coordinates (unclamped), fy/fx: f32 (H, W)
    fractions in {0, 1/32, ..., 31/32}. Out-of-bounds taps contribute 0
    (BORDER_CONSTANT semantics).
    """
    h, w = img.shape[0], img.shape[1]
    flat = img.reshape(h * w, img.shape[2])

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = jnp.clip(yi, 0, h - 1)
        xc = jnp.clip(xi, 0, w - 1)
        v = jnp.take(flat, (yc * w + xc).reshape(-1), axis=0).reshape(h, w, img.shape[2])
        return jnp.where(valid[..., None], v, 0.0)

    fy3 = fy[..., None]
    fx3 = fx[..., None]
    return (
        (1.0 - fy3) * (1.0 - fx3) * tap(y0, x0)
        + (1.0 - fy3) * fx3 * tap(y0, x0 + 1)
        + fy3 * (1.0 - fx3) * tap(y0 + 1, x0)
        + fy3 * fx3 * tap(y0 + 1, x0 + 1)
    )
