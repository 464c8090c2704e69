"""Qt-free tests for the GUI's pure logic (reference components #23-25,
crt_filter.py:1275-1341 preview reader, :1810-1852/:1958-2017 preview
math). PySide6 is absent on headless hosts, so everything extractable from
the Qt closure is exercised here."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from conftest import synth_frames
from pythoncrt_tpu import EffectParams, oracle
from pythoncrt_tpu.gui_qt import (
    PREVIEW_MAX_H,
    PREVIEW_MAX_W,
    PreviewReader,
    _preview_size,
    render_preview_frame,
)
from pythoncrt_tpu.text import overlay_for


class TestPreviewSize:
    def test_small_frames_untouched(self):
        assert _preview_size(320, 240) == (320, 240)

    def test_large_frames_fit_bounds(self):
        w, h = _preview_size(3840, 2160)
        assert w <= PREVIEW_MAX_W and h <= PREVIEW_MAX_H
        assert w / h == pytest.approx(3840 / 2160, rel=0.01)

    def test_degenerate_sizes(self):
        assert _preview_size(0, 0) == (1, 1)


class TestRenderPreviewFrame:
    def test_matches_oracle_stateless(self):
        frame = synth_frames(1, 48, 64, seed=7)[0]
        p = EffectParams(noise_strength=0.0, persistence=0.0)
        got, prev = render_preview_frame(frame, p, t=0.5, stateful=False)
        ref = oracle.ops.to_uint8(
            oracle.apply_effects(
                frame, p, phase_px=0.5 * p.scanline_speed_px_s, time_sec=0.5,
                noise_field=None, text_rgba=overlay_for(64, 48, p.text),
                engine="preview",
            )
        )
        assert prev is None
        np.testing.assert_array_equal(got, ref)

    def test_stateful_persistence_chains(self):
        frames = synth_frames(2, 48, 64, seed=8)
        p = EffectParams(noise_strength=0.0, persistence=0.6)
        out0, s0 = render_preview_frame(frames[0], p, t=0.0, stateful=True)
        assert s0 is not None
        out1, s1 = render_preview_frame(
            frames[1], p, t=1 / 24.0, prev_img=s0, stateful=True
        )
        # second frame must differ from its stateless render (blended)
        out1_free, _ = render_preview_frame(frames[1], p, t=1 / 24.0,
                                            stateful=False)
        assert not np.array_equal(out1, out1_free)

    def test_mismatched_prev_state_resets(self):
        frame = synth_frames(1, 48, 64, seed=9)[0]
        p = EffectParams(noise_strength=0.0, persistence=0.6)
        bad_prev = np.zeros((24, 32, 3), np.float32)
        out, s = render_preview_frame(frame, p, t=0.0, prev_img=bad_prev,
                                      stateful=True)
        assert s.shape == (48, 64, 3)

    def test_downscales_large_frames(self):
        frame = np.zeros((2160, 3840, 3), np.uint8)
        p = EffectParams(noise_strength=0.0, persistence=0.0)
        out, _ = render_preview_frame(frame, p, t=0.0)
        assert out.shape[0] <= PREVIEW_MAX_H and out.shape[1] <= PREVIEW_MAX_W


class TestPreviewReader:
    @pytest.fixture
    def clip(self, tmp_path):
        frames = synth_frames(6, 32, 48, seed=4)
        path = tmp_path / "prev.mp4"
        wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             24, (48, 32))
        for f in frames:
            wr.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        wr.release()
        return str(path)

    def test_metadata(self, clip):
        r = PreviewReader(clip)
        assert r.size == (48, 32)
        assert r.fps == pytest.approx(24, abs=0.5)
        assert r.duration == pytest.approx(6 / 24, abs=0.05)
        r.close()

    def test_read_next_restarts_on_eof(self, clip):
        r = PreviewReader(clip)
        seen = [r.read_next() for _ in range(8)]  # 6 frames + wrap
        assert all(f is not None and f.shape == (32, 48, 3) for f in seen)
        r.close()

    def test_frame_at_seeks(self, clip):
        r = PreviewReader(clip)
        f0 = r.frame_at(0.0)
        f5 = r.frame_at(5 / 24.0)
        assert f0 is not None and f5 is not None
        assert not np.array_equal(f0, f5)
        r.close()


class TestQtOffscreenSmoke:
    """Exercises the real Qt window when PySide6 exists (components
    #23-25); skipped on headless hosts where it doesn't."""

    def test_window_builds_offscreen(self, clip_file, monkeypatch):
        pytest.importorskip("PySide6", reason="PySide6 not installed "
                            "on this host (GUI is optional; logic is "
                            "covered Qt-free above)")
        monkeypatch.setenv("QT_QPA_PLATFORM", "offscreen")
        from PySide6.QtWidgets import QApplication

        from pythoncrt_tpu.gui_qt import qt_classes

        app = QApplication.instance() or QApplication([])
        win = qt_classes().CRTWindow()
        # preset plumbing round-trips through the real controls
        s = win._collect_settings()
        win._apply_settings(s)
        assert win._collect_settings() == s
        win.close()
        app.processEvents()

    @pytest.fixture
    def clip_file(self, tmp_path):
        frames = synth_frames(4, 32, 48, seed=7)
        path = tmp_path / "smoke.mp4"
        wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             24, (48, 32))
        for f in frames:
            wr.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        wr.release()
        return str(path)


class TestEnginePreview:
    """Round 4: the engine-backed preview path (render_preview_frame
    use_engine=True) — a compiled preview-sized CRTEngine with the
    preview's injected time-seeded grain and preview glitch semantics —
    must match the oracle preview within the engine parity contract."""

    def test_engine_preview_matches_oracle(self, monkeypatch):
        frame = synth_frames(1, 48, 64, seed=21)[0]
        p = EffectParams(noise_strength=6.0, glitch_amp_px=4,
                         glitch_height_frac=0.4, scanline_strength=0.5,
                         vignette_strength=0.2, persistence=0.0)
        ref, _ = render_preview_frame(frame, p, t=0.7, use_engine=False)
        # forbid the silent oracle fallback INSIDE the engine-mode call:
        # a broken engine path must fail here, not pass vacuously
        from pythoncrt_tpu import gui_qt

        def no_fallback(*a, **k):
            raise AssertionError("engine preview fell back to the oracle")

        monkeypatch.setattr(gui_qt.oracle, "apply_effects", no_fallback)
        got, _ = render_preview_frame(frame, p, t=0.7, use_engine=True)
        monkeypatch.undo()
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32)).max()
        assert diff <= 1

    def test_engine_cache_reuses_and_evicts(self):
        from pythoncrt_tpu import gui_qt

        gui_qt._PREVIEW_ENGINES.clear()
        p = EffectParams(noise_strength=0.0, persistence=0.0)
        e1 = gui_qt._get_preview_engine(p, 64, 48)
        assert gui_qt._get_preview_engine(p, 64, 48) is e1
        for i in range(gui_qt._PREVIEW_ENGINES_MAX):
            gui_qt._get_preview_engine(
                EffectParams(scanline_strength=0.1 * (i + 1),
                             noise_strength=0.0), 64, 48)
        assert len(gui_qt._PREVIEW_ENGINES) == gui_qt._PREVIEW_ENGINES_MAX

    def test_engine_failure_falls_back_to_oracle(self, monkeypatch):
        from pythoncrt_tpu import gui_qt

        monkeypatch.setattr(gui_qt, "_get_preview_engine",
                            lambda *a: (_ for _ in ()).throw(RuntimeError()))
        frame = synth_frames(1, 48, 64, seed=22)[0]
        p = EffectParams(noise_strength=0.0, persistence=0.0)
        got, _ = render_preview_frame(frame, p, t=0.3, use_engine=True)
        ref, _ = render_preview_frame(frame, p, t=0.3, use_engine=False)
        np.testing.assert_array_equal(got, ref)

    def test_persistence_slider_is_a_cache_hit(self):
        """The compiled preview engine is persistence-independent
        (persistence blends host-side), so the cache keys on the
        persistence-ZEROED params — dragging the persistence slider
        must never rebuild/evict (each build costs seconds live)."""
        import dataclasses

        from pythoncrt_tpu import gui_qt

        gui_qt._PREVIEW_ENGINES.clear()
        p = EffectParams(noise_strength=0.0, persistence=0.2)
        e1 = gui_qt._get_preview_engine(p, 64, 48)
        for v in (0.25, 0.5, 0.95):
            p2 = dataclasses.replace(p, persistence=v)
            assert gui_qt._get_preview_engine(p2, 64, 48) is e1
        assert len(gui_qt._PREVIEW_ENGINES) == 1

    def test_engine_build_failure_is_negative_cached(self, monkeypatch):
        """A preset whose engine build fails must not retry the
        (seconds-long) build on every preview tick: the failure is
        cached and _get_preview_engine returns None (oracle path)."""
        from pythoncrt_tpu import engine as eng_mod
        from pythoncrt_tpu import gui_qt

        gui_qt._PREVIEW_ENGINES.clear()
        calls = []

        def boom(*a, **k):
            calls.append(1)
            raise RuntimeError("build failed")

        monkeypatch.setattr(eng_mod, "CRTEngine", boom)
        p = EffectParams(noise_strength=0.0, persistence=0.0)
        assert gui_qt._get_preview_engine(p, 64, 48) is None
        assert gui_qt._get_preview_engine(p, 64, 48) is None
        assert len(calls) == 1
        gui_qt._PREVIEW_ENGINES.clear()

    def test_negative_cache_expires_and_retries(self, monkeypatch):
        """A transient build failure (e.g. HBM held by an export) must
        not pin the preset to the oracle path forever: the failure entry
        carries a TTL and the build retries after it expires."""
        import time as _time

        from pythoncrt_tpu import engine as eng_mod
        from pythoncrt_tpu import gui_qt

        gui_qt._PREVIEW_ENGINES.clear()
        calls = []

        def boom(*a, **k):
            calls.append(1)
            raise RuntimeError("transient failure")

        monkeypatch.setattr(eng_mod, "CRTEngine", boom)
        p = EffectParams(noise_strength=0.0, persistence=0.0)
        t0 = _time.monotonic()
        assert gui_qt._get_preview_engine(p, 64, 48) is None
        assert len(calls) == 1
        # within TTL: cached, no retry
        assert gui_qt._get_preview_engine(p, 64, 48) is None
        assert len(calls) == 1
        # past TTL: retried
        monkeypatch.setattr(
            "time.monotonic",
            lambda: t0 + gui_qt._PREVIEW_FAIL_TTL_S + 1.0)
        assert gui_qt._get_preview_engine(p, 64, 48) is None
        assert len(calls) == 2
        gui_qt._PREVIEW_ENGINES.clear()

    def test_engine_cache_is_lru_not_fifo(self):
        """A cache hit refreshes recency: cycling presets must evict
        the least-recently-USED engine, not the oldest-inserted."""
        from pythoncrt_tpu import gui_qt

        gui_qt._PREVIEW_ENGINES.clear()
        hot = EffectParams(noise_strength=0.0, persistence=0.0)
        e_hot = gui_qt._get_preview_engine(hot, 64, 48)
        for i in range(gui_qt._PREVIEW_ENGINES_MAX - 1):
            gui_qt._get_preview_engine(
                EffectParams(scanline_strength=0.1 * (i + 1),
                             noise_strength=0.0), 64, 48)
        # touch the hot entry, then insert one more (forces an eviction)
        assert gui_qt._get_preview_engine(hot, 64, 48) is e_hot
        gui_qt._get_preview_engine(
            EffectParams(vignette_strength=0.4, noise_strength=0.0), 64, 48)
        assert gui_qt._get_preview_engine(hot, 64, 48) is e_hot  # survived


class TestControlWiring:
    """The declarative widget<->EffectParams table (gui_qt.EFFECT_CONTROLS)
    — the live re-render wiring — is data, asserted here without Qt."""

    def _numeric_fields(self):
        import dataclasses

        return {f.name for f in dataclasses.fields(EffectParams)
                if f.name != "text"}

    def test_table_covers_every_effect_field_once(self):
        from pythoncrt_tpu.gui_qt import EFFECT_CONTROLS

        fields = [row[1] for row in EFFECT_CONTROLS]
        assert len(fields) == len(set(fields))
        assert set(fields) == self._numeric_fields()

    def test_kinds_match_field_types(self):
        from pythoncrt_tpu.gui_qt import EFFECT_CONTROLS

        d = EffectParams()
        for attr, field, tab, label, kind, lo, hi, step, dflt in EFFECT_CONTROLS:
            v = getattr(d, field)
            if kind == "b":
                assert isinstance(v, bool), field
            elif kind == "i":
                assert isinstance(v, int) and not isinstance(v, bool), field
            else:
                assert isinstance(v, float), field

    def test_defaults_inside_ranges_and_clamp_stable(self):
        """Every widget default sits in the widget range, and clamping
        any in-range value keeps it in range (the GUI can never produce
        a value the CLI clamp domain rejects into a different range).
        The single explicit default is the documented GUI deviation:
        scanline speed 60 (crt_filter.py:1493) vs CLI 30 (:1177)."""
        import dataclasses

        from pythoncrt_tpu.gui_qt import EFFECT_CONTROLS

        d = EffectParams()
        for attr, field, tab, label, kind, lo, hi, step, dflt in EFFECT_CONTROLS:
            if kind == "b":
                continue
            val = getattr(d, field) if dflt is None else dflt
            assert lo <= val <= hi, field
            for x in (lo, hi, val):
                cl = getattr(
                    dataclasses.replace(d, **{field: x}).clamped(), field)
                assert lo <= cl <= hi, (field, x, cl)
        explicit = [(r[1], r[8]) for r in EFFECT_CONTROLS if r[8] is not None]
        assert explicit == [("scanline_speed_px_s", 60.0)]

    def test_tabs_known(self):
        from pythoncrt_tpu.gui_qt import EFFECT_CONTROLS, EFFECT_TABS

        assert set(r[2] for r in EFFECT_CONTROLS) == set(EFFECT_TABS)


class TestRenderJob:
    """RenderWorker's Qt-free core (gui_qt.run_render_job): progress and
    done signal plumbing, success and failure paths."""

    def test_success_reports_encoder(self, monkeypatch):
        from pythoncrt_tpu import gui_qt, pipeline

        def fake_process_video(progress_cb=None, **kw):
            progress_cb(0.5)
            progress_cb(1.0)
            return True  # used_gpu

        monkeypatch.setattr(pipeline, "process_video", fake_process_video)
        prog, done = [], []
        gui_qt.run_render_job({"input_path": "x"}, prog.append,
                              lambda ok, msg: done.append((ok, msg)))
        assert prog == [0.5, 1.0]
        assert done == [(True, "Hardware encoder")]

    def test_failure_emits_done_false(self, monkeypatch):
        from pythoncrt_tpu import gui_qt, pipeline

        def boom(**kw):
            raise RuntimeError("decode failed")

        monkeypatch.setattr(pipeline, "process_video", boom)
        done = []
        gui_qt.run_render_job({}, lambda v: None,
                              lambda ok, msg: done.append((ok, msg)))
        assert done == [(False, "decode failed")]
