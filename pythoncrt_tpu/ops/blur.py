"""Separable Gaussian blur with replicate borders (JAX).

Numerically matches oracle.ops.gaussian_blur_replicate to within a few
ulps: identical taps in identical order for interior pixels; at the
borders the replicate-clipped taps are PRE-FOLDED into one coefficient
per edge (a handful of f32 additions reassociate — orders of magnitude
under the 1-LSB budget).

Why the fold: the straightforward jnp.pad(mode="edge") lowers to a
concatenate, which XLA MATERIALIZES before the tap slices read it —
at 1080p that is an extra full-image round-trip per axis. A CONSTANT
zero pad is a native XLA Pad op that fuses into the consuming adds, so
the whole axis pass is one fused sweep; the dropped edge contributions
come back as two rank-1 corrections (static coefficient vectors times
the first/last row or column), also fused.

Replaces cv2.GaussianBlur at crt_filter.py:610 (bloom) and :234 (triad
softness, computed host-side instead).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _blur_axis(img: jnp.ndarray, taps: tuple, axis: int) -> jnp.ndarray:
    k = len(taps)
    if k == 1:
        return img * taps[0]
    r = k // 2
    n = img.shape[axis]
    pad = [(0, 0)] * img.ndim
    pad[axis] = (r, r)
    padded = jnp.pad(img, pad)  # constant 0: fuses (edge mode wouldn't)
    out = None
    for i, t in enumerate(taps):
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(i, i + n)
        term = np.float32(t) * padded[tuple(sl)]
        out = term if out is None else out + term

    # Border fixups: taps that the oracle clips onto the edge samples
    # read zeros above, so add (sum of clipped taps) * edge sample.
    cl = np.zeros(n, np.float32)
    cr = np.zeros(n, np.float32)
    idx = np.arange(n)
    for i, t in enumerate(taps):
        src = idx + i - r
        cl[src < 0] += np.float32(t)
        cr[src > n - 1] += np.float32(t)
    shape = [1] * img.ndim
    shape[axis] = n
    first = [slice(None)] * img.ndim
    first[axis] = slice(0, 1)
    last = [slice(None)] * img.ndim
    last[axis] = slice(n - 1, n)
    if cl.any():
        out = out + jnp.asarray(cl).reshape(shape) * img[tuple(first)]
    if cr.any():
        out = out + jnp.asarray(cr).reshape(shape) * img[tuple(last)]
    return out


def gaussian_blur_replicate(img: jnp.ndarray, taps_x: tuple, taps_y: tuple) -> jnp.ndarray:
    """Horizontal-then-vertical separable blur (same axis order as the oracle)."""
    out = img
    if len(taps_x) > 1:
        out = _blur_axis(out, taps_x, axis=1)
    if len(taps_y) > 1:
        out = _blur_axis(out, taps_y, axis=0)
    return out
