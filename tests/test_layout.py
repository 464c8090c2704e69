"""Planar layout (engine layout="planar"): bit-identical to the NHWC
layout on every config class. The step converts planar frames to NHWC
at its edges and transposes carry no arithmetic, so the two layouts must
agree BITWISE — on the uint8 outputs and on the f32 carried state.
"""

import numpy as np
import pytest

from pythoncrt_tpu import CRTEngine

from conftest import synth_frames
from test_engine_configs import B, CASES, FPS, FULL, H, W
from test_engine_vs_oracle import identity_params


def build(params, **kw):
    kw.setdefault("rng", "host")
    return CRTEngine(params, H, W, FPS, **kw)


# the main config classes (bloom, warp, glitch, persistence, 2-D scan)
LAYOUT_CASES = ["c3_full", "no_warp", "with_glitch", "with_persistence",
                "c4_fast", "c2_retro", "c1_scan_vig", "scan_2d",
                "px3_pre_off"]


@pytest.mark.parametrize("name", LAYOUT_CASES)
def test_planar_matches_nhwc(name):
    p = identity_params(**CASES[name])
    frames = synth_frames(B, H, W, seed=7)

    eng_n = build(p)
    out_n, st_n = eng_n.process(frames)
    out_n, st_n = np.asarray(out_n), np.asarray(st_n)

    eng_p = build(p, layout="planar")
    out_p, st_p = eng_p.process(np.transpose(frames, (0, 3, 1, 2)))
    out_p, st_p = np.asarray(out_p), np.asarray(st_p)

    assert out_p.shape == (B, 3, H, W)
    assert st_p.shape == (3, H, W)
    np.testing.assert_array_equal(np.transpose(out_p, (0, 2, 3, 1)), out_n)
    np.testing.assert_array_equal(np.transpose(st_p, (1, 2, 0)), st_n)


def test_planar_ok_resolution():
    """An explicit planar request is honored for every config class:
    the I/O contract stays planar, whatever the chain runs inside."""
    for name in ("c3_full", "with_glitch", "with_persistence",
                 "c1_scan_vig", "scan_2d"):
        eng = build(identity_params(**CASES[name]), layout="planar")
        assert eng.layout == "planar", name
        assert eng.init_state().shape == (3, H, W), name


def test_planar_state_carry():
    """Persistence state round-trips across batches in planar layout."""
    p = identity_params(**CASES["with_persistence"])
    frames = synth_frames(2 * B, H, W, seed=11)

    eng_n = build(p)
    o1, s1 = eng_n.process(frames[:B], np.arange(B))
    o2, s2 = eng_n.process(frames[B:], np.arange(B, 2 * B), state=s1)

    eng_p = build(p, layout="planar")
    pf = np.transpose(frames, (0, 3, 1, 2))
    q1, t1 = eng_p.process(pf[:B], np.arange(B))
    q2, t2 = eng_p.process(pf[B:], np.arange(B, 2 * B), state=t1)

    np.testing.assert_array_equal(np.transpose(np.asarray(q2), (0, 2, 3, 1)),
                                  np.asarray(o2))
    np.testing.assert_array_equal(np.transpose(np.asarray(t2), (1, 2, 0)),
                                  np.asarray(s2))


GBR = (1, 2, 0)  # ffmpeg gbrp: plane i holds color GBR[i]


@pytest.mark.parametrize("name", ["c3_full", "no_warp", "c2_retro",
                                  "with_glitch", "luma_knee"])
def test_planar_gbr_matches_rgb(name):
    """channel_order="gbr": feeding ffmpeg's gbrp plane order must give
    the same bytes as RGB planes, permuted, through the edge permute."""
    overrides = CASES[name]
    p = identity_params(**overrides)
    frames = synth_frames(B, H, W, seed=5)
    planes_rgb = np.transpose(frames, (0, 3, 1, 2))

    eng_r = build(p, layout="planar")
    out_r, st_r = eng_r.process(planes_rgb)
    out_r, st_r = np.asarray(out_r), np.asarray(st_r)

    eng_g = build(p, layout="planar", channel_order="gbr")
    out_g, st_g = eng_g.process(planes_rgb[:, list(GBR)])
    out_g, st_g = np.asarray(out_g), np.asarray(st_g)

    np.testing.assert_array_equal(out_g, out_r[:, list(GBR)])
    np.testing.assert_array_equal(st_g, st_r[list(GBR)])


@pytest.mark.parametrize("name", ["c3_full", "luma_knee"])
def test_planar_gbr_epilogue_xla_matches_rgb(name):
    """The triad mask rows and the preserve-luma weights in the stage
    7-11 epilogue must follow each plane's color under the gbr plane
    order."""
    overrides = CASES[name]
    p = identity_params(**overrides)
    frames = synth_frames(B, H, W, seed=5)
    planes_rgb = np.transpose(frames, (0, 3, 1, 2))

    eng_r = build(p, layout="planar")
    out_r = np.asarray(eng_r.process(planes_rgb)[0])

    eng_g = build(p, layout="planar", channel_order="gbr")
    out_g = np.asarray(eng_g.process(planes_rgb[:, list(GBR)])[0])

    np.testing.assert_array_equal(out_g, out_r[:, list(GBR)])


def test_layout_auto_resolution():
    """"auto" picks NHWC, the layout the chain runs in, for every
    config (a planar request converts at the step edges instead)."""
    assert build(identity_params(**FULL), layout="auto").layout == "nhwc"
    assert build(identity_params(**CASES["c1_scan_vig"]),
                 layout="auto").layout == "nhwc"


def test_planar_shape_check():
    with pytest.raises(ValueError):
        build(identity_params(**FULL), layout="planar").process(
            synth_frames(B, H, W, seed=0))
    with pytest.raises(ValueError):
        CRTEngine(identity_params(**FULL), H, W, FPS, layout="bogus")


def test_planar_mismatched_state_rejected():
    """The layout-dependent state-shape guard (engine.process): a
    planar engine expects a (3, H, W) carry and must refuse an
    NHWC-shaped one (same documented-deviation refusal as NHWC,
    PARITY.md — never a silent transpose)."""
    p = identity_params(**CASES["with_persistence"])
    eng_p = build(p, layout="planar")
    pf = np.transpose(synth_frames(B, H, W, seed=13), (0, 3, 1, 2))
    with pytest.raises(ValueError, match="documented deviation"):
        eng_p.process(pf, np.arange(B),
                      state=np.zeros((H, W, 3), np.float32))
