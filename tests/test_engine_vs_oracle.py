"""Engine-vs-oracle equivalence: the jitted batch engine must match the
CPU ground truth to <= 1 LSB per channel after the uint8 round-trip
(BASELINE.json north star), per stage and for full stacks, across
property-sampled parameters within the CLI clamp domains."""

import dataclasses

import numpy as np
import pytest

from pythoncrt_tpu import CRTEngine, EffectParams, TextParams, oracle
from pythoncrt_tpu.oracle import render_oracle

H, W, FPS = 48, 64, 24.0

IDENTITY = dict(
    scanline_strength=0.0, triad_strength=0.0, aberration_px=0,
    bloom_strength=0.0, noise_strength=0.0, vignette_strength=0.0,
    persistence=0.0, pixel_size=1, fast_bloom=False, glitch_amp_px=0,
    glitch_height_frac=0.0,
)


def identity_params(**overrides) -> EffectParams:
    d = dict(IDENTITY)
    d.update(overrides)
    return EffectParams(**d)


def assert_lsb(eng: CRTEngine, frames: np.ndarray, tol: int = 1,
               text_rgba=None):
    got, _ = eng.process(frames)
    got = np.asarray(got)
    want = render_oracle(eng, frames, text_rgba=text_rgba)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= tol, f"max diff {diff.max()} > {tol} (mean {diff.mean():.4f})"


STAGE_CASES = {
    "aberration": dict(aberration_px=3),
    "aberration_neg": dict(aberration_px=-2),
    "pixelate": dict(pixel_size=3),
    "color_full": dict(brightness=0.1, contrast=1.3, gamma=1.8, saturation=0.5, temperature=0.4),
    "color_desat": dict(saturation=0.0, temperature=-0.6),
    "bloom_fast": dict(bloom_strength=0.4, fast_bloom=True),
    "bloom_gauss": dict(bloom_strength=0.4, bloom_sigma=1.7, fast_bloom=False),
    "bloom_thresh": dict(bloom_strength=0.5, bloom_sigma=2.5, fast_bloom=False, bloom_threshold=0.4),
    "triad_hard": dict(triad_strength=0.5, triad_softness=0.0),
    "triad_soft": dict(triad_strength=0.35, triad_softness=0.8),
    "triad_luma": dict(triad_strength=0.6, triad_softness=0.5, triad_preserve_luma=True),
    "triad_g1": dict(triad_strength=0.5, triad_gamma=1.0),
    "scan_1d": dict(scanline_strength=0.6, scanline_period_px=2.0),
    "scan_2d": dict(scanline_strength=0.5, scanline_angle=12.0, scanline_thickness=2.0),
    "scan_thick": dict(scanline_strength=0.7, scanline_thickness=0.3),
    "vignette": dict(vignette_strength=0.4),
    "flicker": dict(flicker_strength=0.5, flicker_hz=3.0),
    "noise": dict(noise_strength=12.0),
    "grain": dict(noise_strength=20.0, grain_size=3),
    "warp_barrel": dict(warp_strength=0.35),
    "warp_pincushion": dict(warp_strength=-0.5),
    "glitch_export": dict(glitch_amp_px=5, glitch_height_frac=0.4, scanline_speed_px_s=37.0),
}


@pytest.mark.parametrize("name", sorted(STAGE_CASES))
def test_single_stage_parity(frames_small, name):
    p = identity_params(**STAGE_CASES[name])
    eng = CRTEngine(p, H, W, FPS, rng="host")
    assert_lsb(eng, frames_small)


def test_identity_is_exact_passthrough(frames_small):
    eng = CRTEngine(identity_params(), H, W, FPS)
    got, _ = eng.process(frames_small)
    np.testing.assert_array_equal(np.asarray(got), frames_small)


def test_default_params_full_stack(frames_small):
    eng = CRTEngine(EffectParams(), H, W, FPS, rng="host")
    assert_lsb(eng, frames_small)


def test_kitchen_sink_full_stack(frames_small):
    p = EffectParams(
        scanline_strength=0.6, triad_strength=0.4, triad_softness=0.6,
        triad_preserve_luma=True, aberration_px=2, bloom_sigma=1.5,
        bloom_strength=0.3, bloom_threshold=0.2, noise_strength=6.0,
        vignette_strength=0.3, persistence=0.5, pixel_size=2,
        fast_bloom=False, glitch_amp_px=4, glitch_height_frac=0.3,
        brightness=0.05, contrast=1.1, gamma=1.2, saturation=0.8,
        temperature=0.2, flicker_strength=0.3, flicker_hz=2.0,
        grain_size=2, scanline_angle=5.0, scanline_thickness=1.5,
        warp_strength=0.2, scanline_speed_px_s=30.0,
    )
    eng = CRTEngine(p, H, W, FPS, rng="host")
    assert_lsb(eng, frames_small)


def test_fast_precision_close_not_exact(frames_small):
    """--precision fast: documented deviation — within a few LSB of the
    oracle (direct pow instead of the LUT-exact triad path)."""
    p = EffectParams(
        scanline_strength=0.6, triad_strength=0.4, triad_gamma=2.2,
        triad_preserve_luma=True, vignette_strength=0.25, gamma=1.2,
        persistence=0.0, pixel_size=1, aberration_px=0,
        bloom_strength=0.0, noise_strength=0.0, fast_bloom=False,
        glitch_amp_px=0, glitch_height_frac=0.0,
    )
    eng = CRTEngine(p, H, W, FPS, rng="host", precision="fast")
    assert not eng.lut_exact
    got, _ = eng.process(frames_small)
    want = render_oracle(eng, frames_small)
    diff = np.abs(np.asarray(got).astype(np.int32) - want.astype(np.int32))
    # pow(1/g) has unbounded slope at 0, so skipping the LUT quantization
    # legitimately moves near-black pixels by ~10 LSB; bulk error stays
    # far smaller. Bounds chosen to catch real breakage, not the
    # documented deviation.
    assert diff.max() <= 16, f"fast mode drifted {diff.max()} LSB"
    assert diff.mean() <= 0.5, f"fast mode mean drift {diff.mean():.3f} LSB"


def test_engine_rejects_bad_precision(frames_small):
    with pytest.raises(ValueError):
        CRTEngine(EffectParams(), H, W, FPS, precision="medium")


def test_persistence_scan_parity(frames_small):
    p = identity_params(persistence=0.8, scanline_strength=0.4)
    eng = CRTEngine(p, H, W, FPS)
    assert_lsb(eng, frames_small)


def test_persistence_state_carries_across_batches(frames_small):
    p = identity_params(persistence=0.6, vignette_strength=0.3)
    eng = CRTEngine(p, H, W, FPS)
    # split into two engine batches; oracle runs the stream in one pass
    out1, state = eng.process(frames_small[:5], np.arange(5))
    out2, _ = eng.process(frames_small[5:], np.arange(5, 8), state=state)
    got = np.concatenate([np.asarray(out1), np.asarray(out2)])
    want = render_oracle(eng, frames_small)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_assoc_scan_matches_sequential(frames_small):
    p = identity_params(persistence=0.9, scanline_strength=0.5)
    eng_seq = CRTEngine(p, H, W, FPS)
    eng_par = CRTEngine(p, H, W, FPS, assoc_scan=True)
    a, sa = eng_seq.process(frames_small)
    b, sb = eng_par.process(frames_small)
    assert np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max() <= 1
    np.testing.assert_allclose(np.asarray(sa), np.asarray(sb), atol=1e-5)


def test_preview_engine_glitch_parity(frames_small):
    p = identity_params(glitch_amp_px=6, glitch_height_frac=0.5, scanline_speed_px_s=300.0)
    eng = CRTEngine(p, H, W, FPS, engine="preview", rng="host")
    assert_lsb(eng, frames_small)


def test_native_rng_deterministic(frames_small):
    p = identity_params(noise_strength=10.0, glitch_amp_px=4, glitch_height_frac=0.3)
    eng1 = CRTEngine(p, H, W, FPS, rng="native", seed=7)
    eng2 = CRTEngine(p, H, W, FPS, rng="native", seed=7)
    a, _ = eng1.process(frames_small)
    b, _ = eng2.process(frames_small)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    eng3 = CRTEngine(p, H, W, FPS, rng="native", seed=8)
    c, _ = eng3.process(frames_small)
    assert not np.array_equal(np.asarray(a), np.asarray(c))


@pytest.mark.parametrize("normal_impl", ["erfinv", "bm"])
def test_native_rng_resume_invariant(frames_small, monkeypatch, normal_impl):
    """Native-mode draws key on the ABSOLUTE frame index (fold_in of
    frame_idx), so a mid-stream restart — the segment-resume shape —
    reproduces the same bytes as a straight run. This is the property
    the opt-in rbg impl FAILS (vmapped rbg draws depend on the batched
    call shape — running this test under PCRT_RNG_IMPL=rbg shows ~32%
    pixel mismatch, which is exactly why threefry stays the default,
    ROADMAP.md); it must hold for any shipped impl — including the r4
    Box-Muller normal transform (PCRT_NORMAL_IMPL=bm,
    engine._draw_normal), whose split/elementwise form is keyed the
    same way."""
    monkeypatch.setenv("PCRT_NORMAL_IMPL", normal_impl)
    p = identity_params(noise_strength=10.0, persistence=0.4,
                        glitch_amp_px=4, glitch_height_frac=0.3)
    eng = CRTEngine(p, H, W, FPS, rng="native", seed=7)
    whole, _ = eng.process(frames_small, np.arange(8))
    # "resume": a FRESH engine (new process) starts at frame 5 with the
    # carried state, exactly as segments.py restores from its snapshot
    head, state = CRTEngine(p, H, W, FPS, rng="native", seed=7).process(
        frames_small[:5], np.arange(5))
    tail, _ = CRTEngine(p, H, W, FPS, rng="native", seed=7).process(
        frames_small[5:], np.arange(5, 8), state=np.asarray(state))
    got = np.concatenate([np.asarray(head), np.asarray(tail)])
    np.testing.assert_array_equal(got, np.asarray(whole))


def test_mismatched_state_rejected(frames_small):
    """Stated deviation (PARITY.md): the export engine refuses a
    shape-mismatched persistence carry (the reference resizes it,
    crt_filter.py:689-693 — a GUI-preview situation the oracle path
    handles; the compiled engine is static-shape by design)."""
    p = identity_params(persistence=0.5)
    eng = CRTEngine(p, H, W, FPS)
    bad = np.zeros((H // 2, W // 2, 3), np.float32)
    with pytest.raises(ValueError, match="documented deviation"):
        eng.process(frames_small, np.arange(8), state=bad)
    # the oracle path DOES implement the reference's resize-blend
    from pythoncrt_tpu import oracle

    out = oracle.persistence_blend(bad, np.zeros((H, W, 3), np.float32), 0.5)
    assert out.shape == (H, W, 3)


def test_native_noise_statistics(frames_small):
    # native on-device noise must match the configured amplitude
    strength = 40.0
    p = identity_params(noise_strength=strength)
    eng = CRTEngine(p, H, W, FPS, rng="native")
    mid = np.full((4, H, W, 3), 128, np.uint8)
    out, _ = eng.process(mid)
    resid = np.asarray(out).astype(np.float32) - 128.0
    # noise is scaled by strength/255 in [0,1] space -> std ~= strength in u8
    assert abs(resid.std() - strength) < strength * 0.15 + 1.0


def test_text_overlay_parity(frames_small):
    rgba = np.zeros((H, W, 4), np.uint8)
    rgba[10:20, 10:40] = [255, 80, 0, 200]
    for after in (True, False):
        p = identity_params(
            scanline_strength=0.4, vignette_strength=0.2,
            text=TextParams(text="HI", after=after),
        )
        eng = CRTEngine(p, H, W, FPS, text_rgba=rgba)
        assert_lsb(eng, frames_small, text_rgba=rgba)


def test_property_sampled_params(frames_small):
    """Random parameter points within the CLI clamp domains (SURVEY §4.2)."""
    rng = np.random.default_rng(42)
    for trial in range(8):
        p = EffectParams(
            scanline_strength=rng.uniform(0, 1),
            triad_strength=rng.uniform(0, 1),
            triad_gamma=rng.uniform(0.5, 3.0),
            triad_preserve_luma=bool(rng.integers(2)),
            triad_softness=rng.uniform(0, 2),
            aberration_px=int(rng.integers(-8, 9)),
            bloom_sigma=rng.uniform(0.3, 3),
            bloom_strength=rng.uniform(0, 1),
            bloom_threshold=rng.uniform(0, 1),
            noise_strength=rng.uniform(0, 20),
            vignette_strength=rng.uniform(0, 1),
            persistence=rng.uniform(0, 0.95),
            scanline_speed_px_s=rng.uniform(-100, 100),
            scanline_period_px=rng.uniform(1, 8),
            fast_bloom=bool(rng.integers(2)),
            pixel_size=int(rng.integers(1, 5)),
            glitch_amp_px=int(rng.integers(0, 8)),
            glitch_height_frac=rng.uniform(0, 1),
            brightness=rng.uniform(-0.3, 0.3),
            contrast=rng.uniform(0.5, 2),
            gamma=rng.uniform(0.5, 2.5),
            saturation=rng.uniform(0, 2),
            temperature=rng.uniform(-1, 1),
            flicker_strength=rng.uniform(0, 1),
            flicker_hz=rng.uniform(0, 10),
            grain_size=int(rng.integers(1, 4)),
            scanline_angle=rng.uniform(-30, 30),
            scanline_thickness=rng.uniform(0.1, 4),
            warp_strength=rng.uniform(-1, 1),
        )
        eng = CRTEngine(p, H, W, FPS, rng="host")
        assert_lsb(eng, frames_small[:4])


def test_multi_step_matches_sequential_steps(frames_small):
    """jitted_multi_step (n chunks scanned in one dispatch) must be
    bitwise identical to n successive jitted_step calls, including the
    persistence carry and the first-frame flag handoff."""
    import jax
    import jax.numpy as jnp

    p = identity_params(persistence=0.6, scanline_strength=0.4,
                        noise_strength=5.0, bloom_strength=0.3,
                        warp_strength=0.1)
    eng = CRTEngine(p, H, W, FPS, rng="host")
    n, b = 2, 4
    frames = frames_small[: n * b]
    aux = eng.make_aux(np.arange(n * b))

    # sequential reference
    step = eng.jitted_step()
    state = eng.init_state()
    outs_seq = []
    for i in range(n):
        chunk_aux = jax.tree.map(lambda a: a[i * b:(i + 1) * b], aux)
        first = jnp.full((1,), i == 0, jnp.bool_)
        out, state = step(jnp.asarray(frames[i * b:(i + 1) * b]),
                          chunk_aux, state, first, eng._c)
        outs_seq.append(np.asarray(out))
    state_seq = np.asarray(state)

    # one multi-step dispatch
    stack = jnp.asarray(frames).reshape((n, b) + frames.shape[1:])
    aux_stack = jax.tree.map(
        lambda a: jnp.reshape(a, (n, b) + a.shape[1:]), aux)
    outs_m, state_m = eng.jitted_multi_step()(
        stack, aux_stack, eng.init_state(),
        jnp.full((1,), True, jnp.bool_), eng._c)

    np.testing.assert_array_equal(np.asarray(outs_m),
                                  np.stack(outs_seq))
    np.testing.assert_array_equal(np.asarray(state_m), state_seq)


@pytest.mark.parametrize("mode", ["raw", "half", "off", "roll"])
def test_grain_upsample_forms_match_oracle(frames_small, monkeypatch, mode):
    """Every grain-upsample form must stay <= 1 LSB vs the oracle through
    a grain-heavy stack (engine.py grain gates): "half" is the default
    bf16 half-row form, "raw" the take-based taps on the raw field
    (PCRT_GRAIN_GATHER=1), "off" the two f32 dots at full precision
    (PCRT_GRAIN_LERP=0) and "roll" the exact roll form
    (PCRT_GRAIN_ROLL=1)."""
    env = {"raw": "PCRT_GRAIN_GATHER", "off": "PCRT_GRAIN_LERP",
           "roll": "PCRT_GRAIN_ROLL"}
    if mode in env:
        monkeypatch.setenv(env[mode], "0" if mode == "off" else "1")
    p = identity_params(noise_strength=12.0, grain_size=2,
                        scanline_strength=0.3, bloom_strength=0.3,
                        bloom_sigma=1.2)
    eng = CRTEngine(p, H, W, FPS, rng="host")
    assert eng._grain_lerp == (mode == "half")
    assert eng._grain_mx == (mode in ("half", "off"))
    assert eng._grain_roll == (mode == "roll")
    assert_lsb(eng, frames_small[:4])
