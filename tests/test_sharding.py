"""Multi-chip sharding tests on an 8-device virtual CPU mesh
(SURVEY.md §4 item 5): sharded-batch parity with the single-device
engine, persistence carry handoff across shard boundaries, and
clip-axis independence."""

import jax
import numpy as np
import pytest

from conftest import synth_frames
from pythoncrt_tpu import CRTEngine, EffectParams
from pythoncrt_tpu.parallel import MultiClipEngine, ShardedCRTEngine, make_mesh

H, W, FPS = 48, 64, 24.0

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def u8diff(a, b):
    return np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max()


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


class TestFrameSharding:
    def test_stateless_parity(self, mesh):
        frames = synth_frames(16, H, W)
        p = EffectParams(persistence=0.0, noise_strength=0.0)
        eng = CRTEngine(p, H, W, FPS)
        ref, _ = eng.process(frames)
        sh = ShardedCRTEngine(eng, mesh)
        got, _ = sh.process(frames)
        assert u8diff(got, ref) == 0

    def test_persistence_carry_across_shards(self, mesh):
        frames = synth_frames(16, H, W, seed=5)
        p = EffectParams(persistence=0.7, noise_strength=0.0)
        eng = CRTEngine(p, H, W, FPS)
        ref, ref_state = eng.process(frames)
        sh = ShardedCRTEngine(eng, mesh)
        got, got_state = sh.process(frames)
        assert u8diff(got, ref) <= 1
        np.testing.assert_allclose(
            np.asarray(got_state), np.asarray(ref_state), atol=1e-4
        )

    def test_state_chains_between_sharded_batches(self, mesh):
        frames = synth_frames(32, H, W, seed=9)
        p = EffectParams(persistence=0.9, noise_strength=0.0)
        eng = CRTEngine(p, H, W, FPS)
        ref, _ = eng.process(frames)
        sh = ShardedCRTEngine(eng, mesh)
        o1, s = sh.process(frames[:16], np.arange(16))
        o2, _ = sh.process(frames[16:], np.arange(16, 32), state=s)
        got = np.concatenate([np.asarray(o1), np.asarray(o2)])
        assert u8diff(got, np.asarray(ref)) <= 1

    def test_high_persistence_long_chain(self, mesh):
        # stress the affine composition accuracy at p near the clamp max
        frames = synth_frames(24, H, W, seed=11)
        p = EffectParams(persistence=0.95, noise_strength=0.0, scanline_strength=0.3)
        eng = CRTEngine(p, H, W, FPS)
        ref, _ = eng.process(frames)
        sh = ShardedCRTEngine(eng, mesh)
        got, _ = sh.process(frames)
        assert u8diff(got, ref) <= 1

    def test_rejects_indivisible_batch(self, mesh):
        eng = CRTEngine(EffectParams(), H, W, FPS)
        sh = ShardedCRTEngine(eng, mesh)
        with pytest.raises(ValueError):
            sh.process(synth_frames(10, H, W))

    def test_rejects_mismatched_layout_shape(self, mesh):
        # same clean-error contract as MultiClipEngine / CRTEngine: an
        # NHWC batch into a planar-built engine (and vice versa) raises
        # up front instead of a cryptic kernel shape error
        frames = synth_frames(16, H, W)
        eng = CRTEngine(EffectParams(persistence=0.5), H, W, FPS)
        sh = ShardedCRTEngine(eng, mesh)
        with pytest.raises(ValueError, match="layout"):
            sh.process(np.transpose(frames, (0, 3, 1, 2)))
        eng_p = CRTEngine(EffectParams(persistence=0.5), H, W, FPS,
                          layout="planar")
        shp = ShardedCRTEngine(eng_p, mesh)
        with pytest.raises(ValueError, match="layout"):
            shp.process(frames)
        with pytest.raises(ValueError, match="layout"):
            planar = np.transpose(frames, (0, 3, 1, 2))
            shp.process_stack(planar.reshape((2, 8) + planar.shape[1:])
                              .transpose(0, 1, 3, 2, 4),  # corrupt dims
                              np.arange(16).reshape(2, 8))

    def test_output_sharding_layout(self, mesh):
        frames = synth_frames(8, H, W)
        eng = CRTEngine(EffectParams(persistence=0.0, noise_strength=0.0), H, W, FPS)
        sh = ShardedCRTEngine(eng, mesh)
        out, _ = sh.process(frames)
        # output stays sharded across the frame axis (no gather at encode)
        assert len(out.sharding.device_set) == 8


class TestClipSharding:
    def test_clips_match_independent_renders(self):
        mesh = make_mesh(8, axis="clips")
        p = EffectParams(persistence=0.5, noise_strength=0.0)
        eng = CRTEngine(p, H, W, FPS)
        clips = np.stack([synth_frames(4, H, W, seed=i) for i in range(8)])
        idx = np.tile(np.arange(4), (8, 1))
        mc = MultiClipEngine(eng, mesh)
        got, states = mc.process(clips, idx)
        got = np.asarray(got)
        for i in range(8):
            # reference semantics: states=None means stream start — each
            # clip's frame 0 passes through unblended (crt_filter.py:1094)
            ref, _ = eng.process(clips[i], np.arange(4), state=None)
            assert u8diff(got[i], ref) == 0

    def test_states_continue_streams(self):
        mesh = make_mesh(8, axis="clips")
        p = EffectParams(persistence=0.5, noise_strength=0.0)
        eng = CRTEngine(p, H, W, FPS)
        clips = np.stack([synth_frames(8, H, W, seed=10 + i) for i in range(8)])
        mc = MultiClipEngine(eng, mesh)
        o1, states = mc.process(clips[:, :4], np.tile(np.arange(4), (8, 1)))
        o2, _ = mc.process(clips[:, 4:], np.tile(np.arange(4, 8), (8, 1)),
                           states=states)
        got = np.concatenate([np.asarray(o1), np.asarray(o2)], axis=1)
        for i in range(8):
            ref, _ = eng.process(clips[i], np.arange(8), state=None)
            assert u8diff(got[i], ref) <= 1

    def test_host_rng_matches_independent_renders(self):
        """rng='host' through the clip-sharded engine (lifted in round 5):
        every host-rng aux field is frame-index keyed, so clips sharing
        frame indices draw the same streams as N independent renders."""
        mesh = make_mesh(8, axis="clips")
        p = EffectParams(persistence=0.5, noise_strength=6.0,
                         glitch_amp_px=4, glitch_height_frac=0.4,
                         scanline_speed_px_s=45.0)
        eng = CRTEngine(p, H, W, FPS, rng="host")
        clips = np.stack([synth_frames(4, H, W, seed=80 + i) for i in range(8)])
        idx = np.tile(np.arange(4), (8, 1))
        mc = MultiClipEngine(eng, mesh)
        got = np.asarray(mc.process(clips, idx)[0])
        for i in range(8):
            ref, _ = eng.process(clips[i], np.arange(4), state=None)
            assert u8diff(got[i], ref) == 0

    def test_process_stack_matches_sequential(self):
        """MultiClipEngine.process_stack (n clip-batches scanned in one
        dispatch) must be bitwise identical to n successive process()
        calls, per-clip carries included."""
        mesh = make_mesh(8, axis="clips")
        p = EffectParams(persistence=0.5, noise_strength=0.0)
        eng = CRTEngine(p, H, W, FPS)
        clips = np.stack([synth_frames(8, H, W, seed=60 + i) for i in range(8)])
        mc = MultiClipEngine(eng, mesh)
        o1, st = mc.process(clips[:, :4], np.tile(np.arange(4), (8, 1)))
        o2, st2 = mc.process(clips[:, 4:], np.tile(np.arange(4, 8), (8, 1)),
                             states=st)
        stack = np.stack([clips[:, :4], clips[:, 4:]])
        idx = np.stack([np.tile(np.arange(4), (8, 1)),
                        np.tile(np.arange(4, 8), (8, 1))])
        om, stm = mc.process_stack(stack, idx)
        np.testing.assert_array_equal(np.asarray(om[0]), np.asarray(o1))
        np.testing.assert_array_equal(np.asarray(om[1]), np.asarray(o2))
        np.testing.assert_array_equal(np.asarray(stm), np.asarray(st2))


class TestMultiClipLayout:
    """MultiClipEngine is layout-complete: the planar layout runs under
    the clip mesh (edge conversion, persistence kernel included), and
    mis-shaped inputs are rejected instead of silently mis-processed."""

    def _clip_engines(self, overrides, n=8, hh=48, ww=256):
        from test_engine_vs_oracle import identity_params

        p = identity_params(**overrides)
        kw = dict(rng="host")
        eng_n = CRTEngine(p, hh, ww, FPS, **kw)
        eng_p = CRTEngine(p, hh, ww, FPS, layout="planar", **kw)
        clips = np.stack([synth_frames(4, hh, ww, seed=90 + i)
                          for i in range(n)])
        idx = np.tile(np.arange(4), (n, 1))
        return eng_n, eng_p, clips, idx

    def _planar_mc_matches_nhwc(self, overrides):
        from test_engine_configs import CASES

        eng_n, eng_p, clips, idx = self._clip_engines(CASES[overrides])
        mesh = make_mesh(8, axis="clips")
        ref, ref_st = MultiClipEngine(eng_n, mesh).process(clips, idx)
        pc = np.ascontiguousarray(np.transpose(clips, (0, 1, 4, 2, 3)))
        got, got_st = MultiClipEngine(eng_p, mesh).process(pc, idx)
        got = np.transpose(np.asarray(got), (0, 1, 3, 4, 2))
        got_st = np.transpose(np.asarray(got_st), (0, 2, 3, 1))
        np.testing.assert_array_equal(got, np.asarray(ref))
        np.testing.assert_array_equal(got_st, np.asarray(ref_st))

    def test_planar_persist_matches_nhwc(self):
        # planar clips with persistence under the clip mesh
        eng_n, eng_p, _, _ = self._clip_engines(
            {"persistence": 0.5, "scanline_strength": 0.6,
             "bloom_strength": 0.25, "bloom_sigma": 1.2,
             "fast_bloom": False, "warp_strength": 0.15})
        assert eng_p.layout == "planar" and eng_p.params.persistence_on
        self._planar_mc_matches_nhwc("with_persistence")

    def test_planar_glitch_matches_nhwc(self):
        self._planar_mc_matches_nhwc("with_glitch")

    def test_planar_edge_convert_matches_nhwc(self):
        # 2-D scanlines: the shard-edge NHWC conversion must be bitwise
        from test_engine_configs import CASES

        eng_n, eng_p, clips, idx = self._clip_engines(CASES["scan_2d"])
        assert eng_p.layout == "planar"
        self._planar_mc_matches_nhwc("scan_2d")

    def test_rejects_mismatched_layout_shape(self):
        eng_n, eng_p, clips, idx = self._clip_engines(
            {"persistence": 0.5, "scanline_strength": 0.6})
        mesh = make_mesh(8, axis="clips")
        mc = MultiClipEngine(eng_p, mesh)
        with pytest.raises(ValueError, match="layout"):
            mc.process(clips, idx)  # NHWC-shaped clips, planar engine
        mcn = MultiClipEngine(eng_n, mesh)
        with pytest.raises(ValueError, match="layout"):
            mcn.process(np.transpose(clips, (0, 1, 4, 2, 3)), idx)

    def test_planar_process_stack_matches_sequential(self):
        from test_engine_configs import CASES

        _, eng_p, clips, _ = self._clip_engines(CASES["with_persistence"])
        mesh = make_mesh(8, axis="clips")
        mc = MultiClipEngine(eng_p, mesh)
        pc = np.ascontiguousarray(np.transpose(clips, (0, 1, 4, 2, 3)))
        o1, st = mc.process(pc[:, :2], np.tile(np.arange(2), (8, 1)))
        o2, st2 = mc.process(pc[:, 2:], np.tile(np.arange(2, 4), (8, 1)),
                             states=st)
        stack = np.stack([pc[:, :2], pc[:, 2:]])
        idx = np.stack([np.tile(np.arange(2), (8, 1)),
                        np.tile(np.arange(2, 4), (8, 1))])
        om, stm = mc.process_stack(stack, idx)
        np.testing.assert_array_equal(np.asarray(om[0]), np.asarray(o1))
        np.testing.assert_array_equal(np.asarray(om[1]), np.asarray(o2))
        np.testing.assert_array_equal(np.asarray(stm), np.asarray(st2))


class TestShardedPipeline:
    def test_process_video_sharded_matches_single(self, tmp_path):
        """Full pipeline E2E with the frame axis sharded over the
        8-device CPU mesh vs forced single-device."""
        import cv2

        from pythoncrt_tpu import EffectParams
        from pythoncrt_tpu.pipeline import process_video
        from test_pipeline import read_clip, write_clip

        frames = synth_frames(19, H, W, seed=21)  # full batches + ragged tail
        src = write_clip(tmp_path / "in.mp4", frames)
        p = EffectParams(persistence=0.6, noise_strength=0.0)
        out_s = tmp_path / "sharded.mp4"
        out_1 = tmp_path / "single.mp4"
        process_video(src, out_s, p, batch_size=8, sharding="auto", report=False)
        process_video(src, out_1, p, batch_size=8, sharding="none", report=False)
        a, b = read_clip(out_s), read_clip(out_1)
        assert a.shape == b.shape == frames.shape
        # same engine math + same encoder: decoded outputs match closely
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 2


class TestShardedPallasKernels:
    """The structured XLA stages (warp gather, glitch shear) and the full
    stack under shard_map on the virtual CPU mesh match the
    single-device engine (real multi-device meshes run the same
    program per shard)."""

    def test_warp_and_glitch_kernels_shard(self, mesh):
        frames = synth_frames(16, 32, 128, seed=11)
        p = EffectParams(
            persistence=0.3, warp_strength=0.2, glitch_amp_px=4,
            glitch_height_frac=0.4, noise_strength=0.0,
        )
        eng = CRTEngine(p, 32, 128, FPS, rng="host")
        assert p.warp_on and p.glitch_on and eng._glitch_rows > 0
        ref, ref_st = eng.process(frames)
        sh = ShardedCRTEngine(eng, mesh)
        got, got_st = sh.process(frames)
        assert u8diff(got, ref) <= 1  # scan vs carry-composed blend order
        np.testing.assert_allclose(
            np.asarray(got_st), np.asarray(ref_st), atol=1e-5
        )

    def test_fused_pipeline_kernel_shards(self, mesh):
        """The full stateless stack (pixelate, aberration, bloom, triad,
        vignette, warp) under shard_map."""
        frames = synth_frames(16, 32, 128, seed=13)
        p = EffectParams(
            bloom_strength=0.3, bloom_sigma=1.2, fast_bloom=False,
            warp_strength=0.2, triad_strength=0.4, vignette_strength=0.3,
            aberration_px=1, pixel_size=2, noise_strength=0.0,
            persistence=0.0,
        )
        eng = CRTEngine(p, 32, 128, FPS)
        ref, ref_st = eng.process(frames)
        sh = ShardedCRTEngine(eng, mesh)
        got, got_st = sh.process(frames)
        assert u8diff(got, ref) == 0  # stateless config: exact
        np.testing.assert_allclose(
            np.asarray(got_st), np.asarray(ref_st), atol=1e-5
        )


class TestShardedRound4:
    """Round-4 sharded-path features: planar layout under the mesh,
    multi-chunk process_stack dispatch batching, and the ppermute
    prefix-scan collective vs the all_gather form."""

    def test_planar_sharded_matches_single(self, mesh):
        frames = synth_frames(16, H, W, seed=31)
        planar = np.ascontiguousarray(np.transpose(frames, (0, 3, 1, 2)))
        p = EffectParams(persistence=0.7, noise_strength=0.0,
                         scanline_strength=0.4)
        eng = CRTEngine(p, H, W, FPS, layout="planar")
        ref, ref_st = eng.process(planar)
        sh = ShardedCRTEngine(eng, mesh)
        got, got_st = sh.process(planar)
        assert u8diff(got, ref) <= 1
        np.testing.assert_allclose(np.asarray(got_st), np.asarray(ref_st),
                                   atol=1e-4)

    def test_process_stack_matches_sequential(self, mesh):
        frames = synth_frames(32, H, W, seed=33)
        p = EffectParams(persistence=0.8, noise_strength=0.0)
        eng = CRTEngine(p, H, W, FPS)
        sh = ShardedCRTEngine(eng, mesh)
        o1, s1 = sh.process(frames[:16], np.arange(16))
        o2, s2 = sh.process(frames[16:], np.arange(16, 32), state=s1)
        om, sm = sh.process_stack(
            np.stack([frames[:16], frames[16:]]),
            np.arange(32).reshape(2, 16))
        np.testing.assert_array_equal(np.asarray(om[0]), np.asarray(o1))
        np.testing.assert_array_equal(np.asarray(om[1]), np.asarray(o2))
        np.testing.assert_allclose(np.asarray(sm), np.asarray(s2), atol=1e-6)

    def test_collective_forms_agree(self, mesh, monkeypatch):
        """ppermute prefix scan (default) vs the r3 all_gather form:
        same math up to f32 combine order."""
        frames = synth_frames(16, H, W, seed=35)
        p = EffectParams(persistence=0.9, noise_strength=0.0)
        eng = CRTEngine(p, H, W, FPS)
        a, sa = ShardedCRTEngine(eng, mesh).process(frames)
        monkeypatch.setenv("PCRT_SHARD_COLLECTIVE", "all_gather")
        b, sb = ShardedCRTEngine(eng, mesh).process(frames)
        assert u8diff(a, b) <= 1
        np.testing.assert_allclose(np.asarray(sa), np.asarray(sb), atol=1e-5)

    def test_stateless_stack_and_planar_exact(self, mesh):
        frames = synth_frames(16, H, W, seed=37)
        p = EffectParams(persistence=0.0, noise_strength=0.0,
                         vignette_strength=0.3)
        eng = CRTEngine(p, H, W, FPS)
        ref, _ = eng.process(frames)
        sh = ShardedCRTEngine(eng, mesh)
        om, _ = sh.process_stack(frames.reshape(2, 8, H, W, 3),
                                 np.arange(16).reshape(2, 8))
        got = np.asarray(om).reshape(16, H, W, 3)
        assert u8diff(got, ref) == 0
