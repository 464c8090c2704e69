"""Color-space stages (JAX): grading, triad apply, text composite.

Float32 elementwise math mirroring oracle.engine exactly; every op here
fuses into the single XLA program the engine emits.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

REC709_R, REC709_G, REC709_B = 0.2126, 0.7152, 0.0722
TRIAD_LUT_SIZE = 1024


def rec709_luma(img: jnp.ndarray) -> jnp.ndarray:
    return REC709_R * img[..., 0] + REC709_G * img[..., 1] + REC709_B * img[..., 2]


def color_adjust(
    img: jnp.ndarray,
    brightness: float,
    contrast: float,
    gamma: float,
    saturation: float,
    temperature: float,
) -> jnp.ndarray:
    """Saturation -> temperature -> brightness/contrast -> gamma
    (crt_filter.py:279-305). Identity stages vanish at trace time since
    all parameters are static Python floats."""
    if saturation != 1.0:
        luma = rec709_luma(img)[..., None]
        img = jnp.clip(luma + (img - luma) * np.float32(saturation), 0.0, 1.0)
    if temperature != 0.0:
        t = float(temperature)
        r_gain = np.float32(np.clip(1.0 + 0.5 * t, 0.5, 1.5))
        b_gain = np.float32(np.clip(1.0 - 0.5 * t, 0.5, 1.5))
        gains = jnp.array([r_gain, np.float32(1.0), b_gain], dtype=jnp.float32)
        img = jnp.clip(img * gains, 0.0, 1.0)
    if brightness != 0.0 or contrast != 1.0:
        img = jnp.clip(
            (img - np.float32(0.5)) * np.float32(contrast)
            + np.float32(0.5)
            + np.float32(brightness),
            0.0,
            1.0,
        )
    if gamma != 1.0 and gamma > 0.0:
        img = jnp.clip(jnp.power(img, np.float32(1.0 / float(gamma))), 0.0, 1.0)
    return img


def _quantize_lut(img: jnp.ndarray) -> jnp.ndarray:
    """Snap values to the reference's 1024-bin LUT grid (crt_filter.py:250).

    The reference's LUT entries are exactly (i/1024)^g evaluated in f32,
    and i/1024 is exact in f32, so quantize-then-pow reproduces the LUT
    lookup without a gather — the pow stays elementwise and fuses.
    """
    idx = jnp.clip((jnp.clip(img, 0.0, 1.0) * TRIAD_LUT_SIZE).astype(jnp.int32), 0, TRIAD_LUT_SIZE)
    return idx.astype(jnp.float32) * np.float32(1.0 / TRIAD_LUT_SIZE)


def apply_triad(
    img: jnp.ndarray,
    mask: jnp.ndarray,
    gamma: float,
    preserve_luma: bool,
    lut_exact: bool = True,
) -> jnp.ndarray:
    """Gamma-aware triad multiply (crt_filter.py:238-263).

    lut_exact=True replicates the 1024-bin quantization observable in the
    reference's output bytes; False uses direct pow (faster, visually
    identical, not bit-matched).
    """
    g = float(gamma)
    if ((not preserve_luma) and abs(g - 1.0) < 1e-3) or g <= 0.0:
        return jnp.clip(img * mask, 0.0, 1.0)
    if lut_exact:
        lin = jnp.power(_quantize_lut(img), np.float32(g))
    else:
        lin = jnp.power(jnp.clip(img, 0.0, 1.0), np.float32(g))
    out_lin = lin * mask
    if preserve_luma:
        y_before = rec709_luma(lin)
        y_after = rec709_luma(out_lin)
        ratio = jnp.clip(y_before / jnp.maximum(y_after, 1e-6), 0.5, 2.0)
        out_lin = out_lin * ratio[..., None]
    if lut_exact:
        out = jnp.power(_quantize_lut(out_lin), np.float32(1.0 / g))
    else:
        out = jnp.power(jnp.clip(out_lin, 0.0, 1.0), np.float32(1.0 / g))
    return jnp.clip(out, 0.0, 1.0)


def composite_text(img: jnp.ndarray, alpha: jnp.ndarray, rgb: jnp.ndarray) -> jnp.ndarray:
    """Alpha-over composite with precomputed f32 alpha (H, W, 1) and rgb
    (H, W, 3) device constants (crt_filter.py:595-597)."""
    return jnp.clip(img * (1.0 - alpha) + rgb * alpha, 0.0, 1.0)


def to_uint8(img: jnp.ndarray) -> jnp.ndarray:
    """float[0,1] -> uint8, round-half-even + saturate
    (cv2.convertScaleAbs semantics, crt_filter.py:696)."""
    return jnp.clip(jnp.rint(img * 255.0), 0.0, 255.0).astype(jnp.uint8)
