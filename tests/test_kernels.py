"""Exact device forms of resampling stages vs the numpy oracle."""

import numpy as np

from pythoncrt_tpu import oracle


def test_resize2x_roll_matches_oracle_bitwise(rng):
    """The grain upsample's roll-form 2x resize (ops/resize.py:
    resize2x_roll) vs the numpy oracle's take-based bilinear: the roll
    form places the SAME taps with the SAME f32 lerp order, so the
    outputs must be bit-identical (crt_filter.py:642 grain upsample)."""
    import jax.numpy as jnp

    from pythoncrt_tpu.ops import resize as oresize

    for gh, gw in ((270, 480), (64, 128), (5, 7), (1, 9)):
        h, w = 2 * gh, 2 * gw
        f = rng.standard_normal((gh, gw)).astype(np.float32)
        want = oracle.ops.resize_bilinear(f, h, w)
        ylo, yf = oracle.ops.bilinear_taps(gh, h)
        xlo, xf = oracle.ops.bilinear_taps(gw, w)
        got = np.asarray(oresize.resize2x_roll(
            jnp.asarray(f),
            jnp.asarray((1.0 - yf).reshape(h, 1)),
            jnp.asarray(yf.reshape(h, 1)),
            jnp.asarray((1.0 - xf).reshape(1, w)),
            jnp.asarray(xf.reshape(1, w))))
        np.testing.assert_array_equal(got, want, err_msg=f"{gh}x{gw}")
