"""The XLA forms of the structured stages — bloom (6), barrel warp (12)
and glitch shear (14) — against the CPU oracle at the radii,
thresholds, strengths, offsets and shapes that matter: odd frame sizes,
black warp corners, offsets at and past the frame width."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pythoncrt_tpu import CRTEngine, oracle
from pythoncrt_tpu.ops import blur as oblur
from pythoncrt_tpu.ops import glitch as oglitch
from pythoncrt_tpu.ops import resize as oresize
from pythoncrt_tpu.ops import warp as owarp

from conftest import synth_frames
from test_engine_vs_oracle import assert_lsb, identity_params


def _bloom_src(img, thr):
    if thr > 0.0:
        t = np.float32(min(0.99, max(0.0, thr)))
        return np.clip((img - t) / np.float32(max(1e-6, 1.0 - float(t))), 0, 1)
    return img


# (sigma, threshold, H, W) for the gaussian variant
GAUSS = [(1.2, 0.0, 24, 128), (2.0, 0.4, 24, 128), (0.5, 0.0, 24, 128),
         (1.2, 0.0, 48, 128), (1.2, 0.0, 32, 256), (2.0, 0.4, 32, 256),
         (0.5, 0.0, 32, 256)]
# (threshold, strength, H, W) for the fast (half-res down+up) variant
FAST = [(0.0, 0.25, 24, 256), (0.4, 0.25, 24, 256), (0.0, 0.25, 48, 256),
        (0.0, 0.25, 32, 256), (0.2, 0.4, 32, 256)]


@pytest.mark.parametrize("sigma,thr,h,w", GAUSS)
def test_gaussian_bloom_matches_oracle(rng, sigma, thr, h, w):
    strength = 0.3
    p = identity_params(bloom_strength=strength, bloom_sigma=sigma,
                        bloom_threshold=thr, fast_bloom=False)
    eng = CRTEngine(p, h, w, 24.0)
    imgs = rng.random((2, h, w, 3), dtype=np.float32)
    got = np.asarray(jax.vmap(lambda im: eng._frame_bloom_xla(eng._c, im))(
        jnp.asarray(imgs)))
    k = max(1, int(round(sigma * 3)) * 2 + 1)
    for b in range(2):
        blur = oracle.ops.gaussian_blur_replicate(
            _bloom_src(imgs[b], thr), k, k, sigma, sigma)
        want = np.clip(imgs[b] + np.float32(strength) * blur, 0, 1)
        # border taps pre-folded (ops/blur.py): a few f32 reassociations
        np.testing.assert_allclose(got[b], want, atol=1e-6)


@pytest.mark.parametrize("thr,strength,h,w", FAST)
def test_fast_bloom_matches_oracle(rng, thr, strength, h, w):
    p = identity_params(bloom_strength=strength, bloom_threshold=thr,
                        fast_bloom=True)
    eng = CRTEngine(p, h, w, 24.0)
    imgs = rng.random((2, h, w, 3), dtype=np.float32)
    got = np.asarray(jax.vmap(lambda im: eng._frame_bloom_xla(eng._c, im))(
        jnp.asarray(imgs)))
    for b in range(2):
        ds = oracle.ops.resize_bilinear(_bloom_src(imgs[b], thr), h // 2, w // 2)
        blur = oracle.ops.resize_bilinear(ds, h, w)
        want = np.clip(imgs[b] + np.float32(strength) * blur, 0, 1)
        np.testing.assert_allclose(got[b], want, atol=1e-6)


def _warp(img, h, w, strength):
    map_x, map_y = oracle.barrel_warp_maps(h, w, strength)
    x0, fx = oracle.ops.split_map(map_x)
    y0, fy = oracle.ops.split_map(map_y)
    got = owarp.bilinear_gather_const0(
        jnp.asarray(img), *(jnp.asarray(a) for a in (y0, x0, fy, fx)))
    return np.asarray(got), oracle.ops.remap_bilinear_const0(img, map_x, map_y)


@pytest.mark.parametrize("strength", [0.0, 0.1, 0.15, 0.3, 0.5, 1.0, -0.5])
def test_warp_matches_oracle(rng, strength):
    img = rng.random((32, 256, 3), dtype=np.float32)
    got, want = _warp(img, 32, 256, strength)
    np.testing.assert_allclose(got, want, atol=1e-6)
    if strength == 0.0:
        np.testing.assert_allclose(got, img, atol=1e-6)


@pytest.mark.parametrize("h,w,strength", [(30, 200, 0.2), (17, 33, 0.4),
                                          (128, 256, 0.8), (64, 512, 1.0)])
def test_warp_odd_shapes_match_oracle(rng, h, w, strength):
    img = rng.random((h, w, 3), dtype=np.float32)
    got, want = _warp(img, h, w, strength)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_warp_black_corners_exact(rng):
    """Where both taps of an axis fall outside the frame the oracle's
    output is exactly 0, and so must the gather's be."""
    img = rng.random((64, 512, 3), dtype=np.float32) + np.float32(0.1)
    got, want = _warp(img, 64, 512, 1.0)
    dead = want == 0.0
    assert dead.sum() > 100  # the corners are really black at s=1
    np.testing.assert_array_equal(got[dead], 0.0)


@pytest.mark.parametrize("strength", [0.15, -0.5])
def test_warp_engine_uint8_lsb(strength):
    """The whole engine with only the warp on, uint8 in and out."""
    eng = CRTEngine(identity_params(warp_strength=strength), 32, 256, 24.0)
    assert_lsb(eng, synth_frames(4, 32, 256, seed=9))


def _shear(img, y0, offs):
    got = oglitch.shear_band(jnp.asarray(img), y0, jnp.asarray(offs))
    return np.asarray(got), oracle.apply_glitch_gather(img, y0, offs)


def test_glitch_per_row_offsets_wrap(rng):
    img = rng.random((32, 128, 3), dtype=np.float32)
    offs = rng.normal(0, 200, 24).astype(np.float32)  # large: wraps
    got, want = _shear(img, 8, offs)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mult,extra", [(1, 0), (-1, 0), (1, 1), (-1, -1),
                                        (2, 3)])
def test_glitch_offsets_at_and_past_width(rng, mult, extra):
    h, w, y0 = 16, 256, 8
    img = rng.random((h, w, 3), dtype=np.float32)
    offs = np.full(h - y0, mult * w + extra, np.float32)
    got, want = _shear(img, y0, offs)
    np.testing.assert_array_equal(got, want)


def test_glitch_rows_above_band_untouched(rng):
    img = rng.random((32, 128, 3), dtype=np.float32)
    y0 = 13
    offs = rng.normal(0, 3, (32 - y0, 128)).astype(np.float32)
    got, want = _shear(img, y0, offs)
    np.testing.assert_array_equal(got[:y0], img[:y0])
    np.testing.assert_array_equal(got, want)


def test_glitch_segment_offsets(rng):
    """Export-mode per-segment offsets expanded through the static
    segment index, as the engine does."""
    h, w, y0, seg = 48, 256, 20, 16
    img = rng.random((h, w, 3), dtype=np.float32)
    seg_offs = rng.normal(0, 5, (h - y0, w // seg)).astype(np.float32)
    per_px = seg_offs[:, np.arange(w) // seg]
    got, want = _shear(img, y0, per_px)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["export", "preview"])
def test_glitch_engine_matches_oracle(mode):
    p = identity_params(glitch_amp_px=6, glitch_height_frac=0.4,
                        scanline_speed_px_s=77.0)
    eng = CRTEngine(p, 48, 256, 24.0, engine=mode, rng="host")
    assert_lsb(eng, synth_frames(4, 48, 256, seed=21))


def test_resize_bilinear_matches_oracle(rng):
    """The take-based bilinear resize the fast bloom and the grain use,
    down and up, at odd sizes."""
    img = rng.random((37, 53, 3), dtype=np.float32)
    for oh, ow in ((18, 26), (74, 106)):
        taps = (*oracle.ops.bilinear_taps(37, oh),
                *oracle.ops.bilinear_taps(53, ow))
        got = np.asarray(oresize.resize_bilinear(
            jnp.asarray(img), *(jnp.asarray(a) for a in taps)))
        np.testing.assert_allclose(
            got, oracle.ops.resize_bilinear(img, oh, ow), atol=1e-6)


def test_blur_taps_sum_to_one():
    taps = oracle.ops.gaussian_kernel_1d(7, 1.2)
    img = jnp.ones((16, 24, 3), jnp.float32)
    out = np.asarray(oblur.gaussian_blur_replicate(
        img, tuple(map(float, taps)), tuple(map(float, taps))))
    np.testing.assert_allclose(out, 1.0, atol=1e-6)
