"""Static-index resize primitives (JAX).

All index maps and bilinear taps are precomputed on the host by the
oracle (pythoncrt_tpu.oracle.ops) so device results are bit-identical to
the ground truth: the device side is pure gathers + lerps that XLA fuses
into the surrounding elementwise chain. Replaces cv2.resize use at
crt_filter.py:582-583 (pixelate), :606-607 (fast bloom), :642 (grain).
"""

from __future__ import annotations

import jax.numpy as jnp


def gather_rows(img: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """img[idx] along axis 0 (idx: int32 [N])."""
    return jnp.take(img, idx, axis=0)


def gather_cols(img: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """img[:, idx] along axis 1 (idx: int32 [N])."""
    return jnp.take(img, idx, axis=1)


def remap_nearest(img: jnp.ndarray, y_map: jnp.ndarray, x_map: jnp.ndarray) -> jnp.ndarray:
    """Composed nearest-neighbour resample: out[y, x] = img[y_map[y], x_map[x]].

    One gather per axis; used for the pixelate (mosaic) stage where the
    down+up nearest resizes compose into a single index map.
    """
    return gather_cols(gather_rows(img, y_map), x_map)


def roll_gather_shifts(index_map) -> "list | None":
    """If the 1-D gather index map reads only nearby positions under
    cyclic wrap (map[c] = (c - s) mod n with few distinct small |s|),
    return the distinct signed shifts; else None. Pixelate's composed
    nearest maps always qualify (each output reads the head pixel of
    its block); composing the wrap-around aberration roll into them
    adds a +-px offset, hence the signed canonical representative."""
    import numpy as np

    m = np.asarray(index_map)
    n = m.shape[0]
    s = (np.arange(n) - m) % n
    s = np.where(s > n // 2, s - n, s)  # smallest-|s| representative
    if np.abs(s).max() > 32 or len(np.unique(s)) > 24:
        return None
    return [int(v) for v in np.unique(s) if v != 0]


def remap_nearest_rolls(img: jnp.ndarray, y_map, x_map,
                        y_shifts, x_shifts,
                        y_axis: int = 0, x_axis: int = 1) -> jnp.ndarray:
    """remap_nearest expressed as shift-selected static rolls — exact:
    out[c] = img[map[c]] with map[c] = c - s(c), and roll(v, s)[c] =
    v[c - s]. A gather can split the surrounding fusion; rolls +
    selects fuse into the elementwise chain.

    y_shifts/x_shifts come from roll_gather_shifts; y_map/x_map are the
    original index maps (device arrays) used to build the per-coordinate
    shift selectors.
    """
    out = img
    for axis, m, shifts in ((y_axis, y_map, y_shifts), (x_axis, x_map, x_shifts)):
        if not shifts:
            continue
        n = img.shape[axis]
        # compare in the mod-n domain so signed canonical shifts (from
        # composed wrap-around rolls) match: roll(v, s) == roll(v, s % n)
        shift = (jnp.arange(n, dtype=jnp.int32) - m.astype(jnp.int32)) % n
        shape = [1] * img.ndim
        shape[axis] = n
        shift = shift.reshape(shape)
        base = out
        res = base
        for s in shifts:
            res = jnp.where(shift == s % n, jnp.roll(base, s, axis=axis), res)
        out = res
    return out


def resize2x_roll(f, wy_lo, wy_hi, wx_lo, wx_hi):
    """Exact 2x bilinear upsample (dst == 2*src per axis) as repeat +
    static rolls — no gathers, so XLA fuses the whole resize into the
    surrounding elementwise chain (the take-based form lowers to row/col
    gathers that can split the fusion; the bf16-matmul form costs two
    dots and truncates the field to bf16).

    Arithmetic is bit-identical to resize_bilinear with
    oracle.ops.bilinear_taps weights (crt_filter.py:642 grain upsample):
    same f32 lerp `lo*(1-frac) + hi*frac`, same rows-then-cols order.
    For dst=2*src the taps are periodic — even outputs read (k-1, k) at
    frac .75, odd read (k, k+1) at frac .25 — so `repeat` + three rolls
    place every tap; the first/last outputs clamp (their stray-tap
    weights are exactly 0.0 or the row-0 override applies), matching the
    oracle's edge-clamp. Callers pass the ACTUAL (1-frac)/frac vectors
    from bilinear_taps, pre-shaped ((h,1) rows, (1,w) cols).
    """
    h = 2 * f.shape[0]
    w = 2 * f.shape[1]

    def axis_pass(r, ax, n, w_lo, w_hi):
        i = jnp.arange(n, dtype=jnp.int32)
        even = (i % 2 == 0).reshape([n, 1] if ax == 0 else [1, n])
        lo = jnp.where(even, jnp.roll(r, 2, axis=ax), jnp.roll(r, 1, axis=ax))
        first = (i == 0).reshape(even.shape)
        lo = jnp.where(first, jnp.take(r, jnp.array([0]), axis=ax), lo)
        hi = jnp.where(even, r, jnp.roll(r, -1, axis=ax))
        last = (i == n - 1).reshape(even.shape)
        hi = jnp.where(last, jnp.take(r, jnp.array([n - 1]), axis=ax), hi)
        return lo * w_lo + hi * w_hi

    rows = axis_pass(jnp.repeat(f, 2, axis=0), 0, h, wy_lo, wy_hi)
    return axis_pass(jnp.repeat(rows, 2, axis=1), 1, w, wx_lo, wx_hi)


def resize_bilinear_axis0(img, lo, frac):
    """2-tap lerp along axis 0. lo: int32 [out], frac: f32 [out]."""
    h = img.shape[0]
    hi = jnp.minimum(lo + 1, h - 1)
    f = frac.reshape((-1,) + (1,) * (img.ndim - 1))
    return jnp.take(img, lo, axis=0) * (1.0 - f) + jnp.take(img, hi, axis=0) * f


def resize_bilinear_axis1(img, lo, frac):
    """2-tap lerp along axis 1."""
    w = img.shape[1]
    hi = jnp.minimum(lo + 1, w - 1)
    f = frac.reshape((1, -1) + (1,) * (img.ndim - 2))
    return jnp.take(img, lo, axis=1) * (1.0 - f) + jnp.take(img, hi, axis=1) * f


def resize_bilinear(img, ylo, yfrac, xlo, xfrac):
    """Separable bilinear resize with host-precomputed taps.

    Matches oracle.ops.resize_bilinear exactly (rows axis first, then
    columns — same accumulation order, same f32 rounding).
    """
    rows = resize_bilinear_axis0(img, ylo, yfrac)
    return resize_bilinear_axis1(rows, xlo, xfrac)
