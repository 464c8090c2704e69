"""The persistence recurrence (stage 15) as the engine runs it — the
lax.scan and the associative scan — against a sequential numpy blend,
across batch lengths, frame sizes, the stream-head flag and per-clip
carries; and the device-independence of the traced step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pythoncrt_tpu import CRTEngine, EffectParams, oracle
from pythoncrt_tpu.parallel import MultiClipEngine, make_mesh

from conftest import synth_frames
from test_engine_vs_oracle import identity_params


def seq_scan(imgs, state, first, p):
    """Sequential reference: the per-step f32 blend in numpy. Returns
    (f32 outs, final carry)."""
    pp, om = np.float32(p), np.float32(1.0 - p)
    s = imgs[0] if first else np.clip(pp * state + om * imgs[0], 0, 1)
    outs = [s]
    for t in range(1, imgs.shape[0]):
        s = np.clip(pp * s + om * imgs[t], 0, 1)
        outs.append(s)
    return np.stack(outs), s


def finish(eng, imgs, state, first):
    out, ns = jax.jit(eng._finish)(
        jnp.asarray(imgs), jnp.asarray(state), jnp.full((1,), first))
    return np.asarray(out), np.asarray(ns)


def check(out, ns, want, want_s):
    # the compiler may contract the blend's mul+add into an FMA where
    # numpy rounds twice: the carry agrees to ~1 ulp per step, the bytes
    # to at most 1 LSB at an exact rounding tie
    d = np.abs(out.astype(int) - oracle.ops.to_uint8(want).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    np.testing.assert_allclose(ns, want_s, atol=1e-6)


@pytest.mark.parametrize("b", [1, 2, 7, 32])
@pytest.mark.parametrize("first", [True, False])
def test_scan_matches_sequential(rng, b, first):
    h, w, p = 9, 40, 0.55
    eng = CRTEngine(identity_params(persistence=p), h, w, 24.0)
    imgs = rng.random((b, h, w, 3), dtype=np.float32)
    state = rng.random((h, w, 3), dtype=np.float32)
    out, ns = finish(eng, imgs, state, first)
    assert out.dtype == np.uint8 and out.shape == (b, h, w, 3)
    check(out, ns, *seq_scan(imgs, state, first, p))


@pytest.mark.parametrize("b", [2, 7, 32])
def test_assoc_scan_matches_sequential(rng, b):
    """The O(log B) associative form reassociates the f32 products:
    within ~1e-5 of the sequential carry, 1 LSB of its bytes."""
    h, w, p = 8, 24, 0.9
    eng = CRTEngine(identity_params(persistence=p), h, w, 24.0,
                    assoc_scan=True)
    imgs = rng.random((b, h, w, 3), dtype=np.float32)
    state = rng.random((h, w, 3), dtype=np.float32)
    out, ns = finish(eng, imgs, state, False)
    want, want_s = seq_scan(imgs, state, False, p)
    d = np.abs(out.astype(int) - oracle.ops.to_uint8(want).astype(int))
    assert d.max() <= 1
    np.testing.assert_allclose(ns, want_s, atol=1e-5)


@pytest.mark.parametrize("h,w", [(5, 7), (37, 53)])
def test_scan_odd_frame_sizes(rng, h, w):
    eng = CRTEngine(identity_params(persistence=0.8), h, w, 24.0)
    imgs = rng.random((3, h, w, 3), dtype=np.float32)
    state = rng.random((h, w, 3), dtype=np.float32)
    out, ns = finish(eng, imgs, state, False)
    check(out, ns, *seq_scan(imgs, state, False, 0.8))


def test_stateless_carry_is_quantized_last_frame(rng):
    """With persistence off no blend reads the carry; the engine keeps
    the last output frame, quantized, so it is layout-independent."""
    eng = CRTEngine(identity_params(vignette_strength=0.3), 16, 24, 24.0)
    frames = rng.integers(0, 256, (4, 16, 24, 3), dtype=np.uint8)
    out, st = eng.process(frames)
    np.testing.assert_array_equal(
        np.asarray(st), np.asarray(out)[-1].astype(np.float32)
        * np.float32(1.0 / 255.0))


@pytest.mark.parametrize("first", [True, False])
def test_multiclip_carries_per_clip(first):
    """MultiClipEngine's vmapped scan keeps one carry per clip: each
    clip's bytes and final carry equal a single-clip engine's, with the
    stream-head flag and with carried-in states."""
    h, w, c, b = 16, 24, 3, 4
    eng = CRTEngine(identity_params(persistence=0.7, scanline_strength=0.3),
                    h, w, 24.0)
    mc = MultiClipEngine(eng, make_mesh(1, axis="clips"))
    clips = np.stack([synth_frames(b, h, w, seed=30 + i) for i in range(c)])
    states = None if first else np.stack(
        [np.full((h, w, 3), 0.1 * (i + 1), np.float32) for i in range(c)])
    idx = np.tile(np.arange(b), (c, 1))
    got, got_st = mc.process(clips, idx, states)
    for i in range(c):
        ref, ref_st = eng.process(
            clips[i], np.arange(b), None if first else states[i])
        np.testing.assert_array_equal(np.asarray(got[i]), np.asarray(ref))
        np.testing.assert_allclose(np.asarray(got_st[i]), np.asarray(ref_st),
                                   atol=1e-7)


def test_step_traces_the_same_on_every_backend(monkeypatch):
    """No branch on the device: the engine traces the same step program
    whatever backend JAX reports (backend faked; nothing compiles)."""
    from pythoncrt_tpu import engine as em

    p = EffectParams(persistence=0.5, glitch_amp_px=4,
                     glitch_height_frac=0.3, warp_strength=0.2)

    def trace(backend):
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        monkeypatch.setattr(em, "_enable_compile_cache", lambda: None)
        eng = CRTEngine(p, 16, 32, 24.0)
        frames = np.zeros((4, 16, 32, 3), np.uint8)
        return str(jax.make_jaxpr(eng._step)(
            frames, eng.make_aux(np.arange(4)), eng.init_state(),
            np.zeros((1,), np.bool_), eng._c))

    assert trace("gpu") == trace("cpu")
