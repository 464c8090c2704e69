"""Whole-chain engine configurations vs the CPU oracle (<= 1 LSB per
channel after the uint8 round trip, the BASELINE.json contract), and the
precision of every f32 matrix product the engine traces: on a GPU an f32
dot at default precision runs in TF32, so each one must ask for full
precision explicitly."""

import jax
import numpy as np
import pytest

from pythoncrt_tpu import CRTEngine
from pythoncrt_tpu.oracle import render_oracle

from conftest import synth_frames
from test_engine_vs_oracle import identity_params

H, W, B, FPS = 48, 256, 4, 24.0

FULL = dict(
    scanline_strength=0.6, triad_strength=0.35, triad_softness=0.5,
    aberration_px=1, bloom_sigma=1.2, bloom_strength=0.25,
    fast_bloom=False, noise_strength=1.5, vignette_strength=0.25,
    persistence=0.0, pixel_size=2, grain_size=2, warp_strength=0.15,
    flicker_strength=0.2, flicker_hz=2.0, brightness=0.02,
    contrast=1.05, gamma=1.1, saturation=0.9, temperature=0.1,
)

# name -> overrides on identity params
CASES = {
    # the c3 full stack: pixelate + grade + blur + epilogue + warp
    "c3_full": FULL,
    # pixelate size off the power-of-two ladder
    "px3_pre_off": {**FULL, "pixel_size": 3},
    # no warp: stage 12 never runs
    "no_warp": {**FULL, "warp_strength": 0.0},
    # glitch after warp
    "with_glitch": {**FULL, "glitch_amp_px": 4, "glitch_height_frac": 0.3,
                    "scanline_speed_px_s": 45.0},
    # persistence after warp
    "with_persistence": {**FULL, "persistence": 0.5},
    # luma-preserving triad + bloom knee
    "luma_knee": {**FULL, "triad_preserve_luma": True,
                  "bloom_threshold": 0.3},
    # gather-path grain upsample (grain_size outside the matmul gate)
    "grain3": {**FULL, "grain_size": 3, "noise_strength": 12.0},
    # bloom alone
    "bloom_only": dict(bloom_strength=0.4, bloom_sigma=1.7,
                       fast_bloom=False),
    # aberration without pixelate
    "ab_only": dict(aberration_px=2, bloom_strength=0.3, bloom_sigma=1.0,
                    vignette_strength=0.3),
    # triad mul-only early-out (gamma≈1, no luma)
    "triad_g1": {**FULL, "triad_gamma": 1.0},
    # 2-D scanlines (sin + pow per pixel)
    "scan_2d": {**FULL, "scanline_angle": 12.0,
                "scanline_thickness": 2.0},
    # the c4 temporal config: fast-bloom core + glitch + persistence
    "c4_fast": dict(scanline_strength=0.6, triad_strength=0.35,
                    aberration_px=1, bloom_strength=0.25, fast_bloom=True,
                    noise_strength=1.5, vignette_strength=0.25,
                    persistence=0.6, pixel_size=1, glitch_amp_px=6,
                    glitch_height_frac=0.3, scanline_speed_px_s=120.0),
    # fast bloom alone with the knee
    "fast_knee": dict(bloom_strength=0.5, fast_bloom=True,
                      bloom_threshold=0.35),
    # bloom off: the c2-class retro stack (scanlines + triad + aberration
    # + noise)
    "c2_retro": dict(scanline_strength=0.6, triad_strength=0.35,
                     triad_softness=0.5, aberration_px=2,
                     noise_strength=4.0, bloom_strength=0.0),
    # bloom off + the full prologue/epilogue/warp chain
    "no_bloom_warp": {**FULL, "bloom_strength": 0.0},
    # bloom off, c1-class (scanlines + vignette only)
    "c1_scan_vig": dict(scanline_strength=0.6, vignette_strength=0.25,
                        bloom_strength=0.0),
    # bloom off + px=3
    "no_bloom_px3": dict(scanline_strength=0.6, triad_strength=0.35,
                         noise_strength=4.0, pixel_size=3,
                         bloom_strength=0.0),
}


def build(params, **kw):
    kw.setdefault("rng", "host")  # the oracle needs the host noise field
    return CRTEngine(params, H, W, FPS, **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_config_matches_oracle(name):
    p = identity_params(**CASES[name])
    frames = synth_frames(B, H, W, seed=3)
    eng = build(p)
    got = np.asarray(eng.process(frames)[0])
    want = render_oracle(eng, frames)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"{name}: vs oracle max {diff.max()}"


def _f32_default_dots(jaxpr) -> list:
    """dot_general equations with an f32 operand and no explicit
    precision, anywhere in the jaxpr (sub-jaxprs of scans, vmaps, jits
    and shard_maps included)."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            f32 = any(v.aval.dtype == np.float32 for v in eqn.invars)
            prec = eqn.params.get("precision")
            default = prec is None or all(
                q in (None, jax.lax.Precision.DEFAULT)
                for q in (prec if isinstance(prec, tuple) else (prec,)))
            if f32 and default:
                found.append(eqn)
        for sub in jax.core.jaxprs_in_params(eqn.params):
            found += _f32_default_dots(sub)
    return found


@pytest.mark.parametrize("name", sorted(CASES))
def test_no_f32_dot_at_default_precision(name, monkeypatch):
    """Trace each config's step (no compile) and its two-dot grain form
    (PCRT_GRAIN_LERP=0, the one f32 product in the engine)."""
    monkeypatch.setenv("PCRT_GRAIN_LERP", "0")
    p = identity_params(**CASES[name])
    eng = build(p)
    frames = np.zeros((B, H, W, 3), np.uint8)
    aux = eng.make_aux(np.arange(B))
    closed = jax.make_jaxpr(eng._step)(
        frames, aux, eng.init_state(), np.zeros((1,), np.bool_), eng._c)
    bad = _f32_default_dots(closed.jaxpr)
    assert not bad, f"{name}: f32 dot at default precision: {bad[0]}"


def test_precision_check_sees_default_f32_dot():
    """The jaxpr walk must flag an f32 product with no precision (the
    check above would pass vacuously otherwise)."""
    import jax.numpy as jnp

    a = np.ones((4, 4), np.float32)
    closed = jax.make_jaxpr(lambda x: jax.vmap(lambda r: r @ x)(x))(a)
    assert _f32_default_dots(closed.jaxpr)
    hi = jax.make_jaxpr(
        lambda x: jnp.matmul(x, x, precision=jax.lax.Precision.HIGHEST))(a)
    assert not _f32_default_dots(hi.jaxpr)
