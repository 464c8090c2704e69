"""Planar (gbrp) pipeline path: ffmpeg decodes G,B,R planes straight
into a planar engine and the planar output pipes back into the encoder
with no host repack. The subprocess ends are faked (no ffmpeg binary is
assumed); the engine leg and the byte contracts are exercised for
real."""

import io

import numpy as np
import numpy.testing  # loaded BEFORE tests patch subprocess.Popen (its
#                       lazy init shells out via subprocess.run)
import pytest

cv2 = pytest.importorskip("cv2")

from conftest import synth_frames
from pythoncrt_tpu import EffectParams
from pythoncrt_tpu import pipeline as pl_mod
from pythoncrt_tpu.io import video as vio
from pythoncrt_tpu.pipeline import process_video

from test_pipeline import write_clip

H, W, N = 48, 256, 8
GBR = np.array([1, 2, 0])  # plane i holds color GBR[i]
RGB_OF = np.argsort(GBR)  # color c sits at plane RGB_OF[c]

PARAMS = EffectParams(
    scanline_strength=0.5, triad_strength=0.3, aberration_px=1,
    bloom_sigma=1.2, bloom_strength=0.25, noise_strength=2.0,
    vignette_strength=0.2, pixel_size=2, grain_size=2, warp_strength=0.1,
    brightness=0.02, contrast=1.05, gamma=1.1, saturation=0.9,
)


class FakeProcReader:
    def __init__(self, payload: bytes):
        self.stdout = io.BytesIO(payload)
        self.stderr = None
        self.stdin = None
        self.returncode = None

    def terminate(self):
        self.returncode = 0

    def kill(self):
        self.returncode = -9

    def wait(self, timeout=None):
        return 0

    def poll(self):
        return self.returncode

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class FakeProcWriter:
    def __init__(self):
        self.stdin = io.BytesIO()
        self.returncode = None

    def wait(self, timeout=None):
        return 0


def test_gbrp_reader_command_and_frames(monkeypatch):
    frames = synth_frames(3, H, W, seed=2)
    planar = np.ascontiguousarray(frames.transpose(0, 3, 1, 2)[:, GBR])
    captured = {}

    def fake_popen(cmd, **kw):
        captured["cmd"] = cmd
        return FakeProcReader(planar.tobytes())

    monkeypatch.setattr(vio, "find_ffmpeg", lambda: "/bin/ffmpeg")
    monkeypatch.setattr(vio.subprocess, "Popen", fake_popen)
    r = vio.FFmpegRawReader("x.mp4", W, H, 24, pipe_format="gbrp")
    cmd = captured["cmd"]
    assert cmd[cmd.index("-pix_fmt") + 1] == "gbrp"
    assert r.frame_shape == (3, H, W)
    got = np.stack(list(r.iter_frames()))
    np.testing.assert_array_equal(got, planar)


def test_gbrp_writer_command_and_bytes(monkeypatch):
    captured = {}

    def fake_popen(cmd, **kw):
        captured["cmd"] = cmd
        captured["proc"] = FakeProcWriter()
        return captured["proc"]

    monkeypatch.setattr(vio, "find_ffmpeg", lambda: "/bin/ffmpeg")
    monkeypatch.setattr(vio.subprocess, "Popen", fake_popen)
    w = vio.FFmpegRawWriter("o.mp4", W, H, 24, "libx264", [], pix_fmt="gbrp")
    cmd = captured["cmd"]
    assert cmd[cmd.index("-pix_fmt") + 1] == "gbrp"
    frame = synth_frames(1, H, W, seed=4)[0].transpose(2, 0, 1)
    w.write_frame(frame)
    assert captured["proc"].stdin.getvalue() == frame.tobytes()


def test_gbrp_requires_ffmpeg(tmp_path):
    if vio.find_ffmpeg() is not None:
        pytest.skip("host has ffmpeg; the no-binary gate is moot")
    with pytest.raises(RuntimeError, match="gbrp"):
        vio.open_reader("x.mp4", W, H, 24, pipe_format="gbrp")
    with pytest.raises(RuntimeError, match="gbrp"):
        vio.open_writer(str(tmp_path / "o.mp4"), W, H, 24, pix_fmt="gbrp")


class PlanarFakeReader:
    """Serves the clip's frames as gbrp planes (what ffmpeg would pipe),
    decoding via cv2 so both pipeline runs see identical input bytes."""

    def __init__(self, path, w, h):
        self.out_w, self.out_h = w, h
        self.frame_shape = (3, h, w)
        self._cap = cv2.VideoCapture(str(path))

    def read_into(self, out):
        ok, f = self._cap.read()
        if not ok:
            return False
        rgb = cv2.cvtColor(f, cv2.COLOR_BGR2RGB)
        out[...] = rgb.transpose(2, 0, 1)[GBR]
        return True

    def close(self):
        self._cap.release()


class CollectWriter:
    def __init__(self, frames):
        self.frames = frames

    def write_frame(self, f):
        self.frames.append(np.array(f))

    def close(self):
        pass


def _engine_planar(monkeypatch):
    """Make the pipeline's layout="auto" request resolve to the planar
    layout (gbrp pipes), which the engine serves by converting at the
    step edges; "auto" itself resolves to NHWC."""
    real = pl_mod.CRTEngine

    def patched(*a, **kw):
        if kw.get("layout") == "auto":
            kw["layout"] = "planar"
        return real(*a, **kw)

    monkeypatch.setattr(pl_mod, "CRTEngine", patched)


def test_planar_pipeline_end_to_end(tmp_path, monkeypatch):
    """process_video on the planar path must produce the same bytes as
    the NHWC path, permuted: the engine leg runs for real, only the
    ffmpeg subprocess ends are faked."""
    clip = write_clip(tmp_path / "in.mp4", synth_frames(N, H, W, seed=6))
    _engine_planar(monkeypatch)

    # --- run 1: NHWC reference (cv2 reader, raw collector writer) ---
    nhwc_frames: list = []
    monkeypatch.setattr(
        vio, "open_writer",
        lambda *a, **k: (CollectWriter(nhwc_frames), False))
    process_video(clip, tmp_path / "o1.mp4", PARAMS, batch_size=4,
                  report=False)
    assert len(nhwc_frames) == N

    # --- run 2: planar path (fake ffmpeg both sides) ---
    planar_frames: list = []
    seen = {}

    def fake_open_writer(*a, **k):
        seen["pix_fmt"] = k.get("pix_fmt")
        return CollectWriter(planar_frames), False

    monkeypatch.setattr(vio, "find_ffmpeg", lambda: "/bin/ffmpeg")
    monkeypatch.setattr(vio, "extract_audio", lambda *a, **k: None)
    monkeypatch.setattr(
        vio, "open_reader",
        lambda src, w, h, fps, *a, **k: PlanarFakeReader(src, w, h))
    monkeypatch.setattr(vio, "open_writer", fake_open_writer)
    process_video(clip, tmp_path / "o2.mp4", PARAMS, batch_size=4,
                  report=False)

    assert seen["pix_fmt"] == "gbrp"
    assert len(planar_frames) == N
    got = np.stack(planar_frames)  # (N, 3, H, W) in GBR plane order
    want = np.stack(nhwc_frames)  # (N, H, W, 3) RGB
    np.testing.assert_array_equal(
        got[:, RGB_OF].transpose(0, 2, 3, 1), want)


def test_planar_pipeline_fallback_config(tmp_path, monkeypatch):
    """With layout="auto" resolving to NHWC, the pipeline keeps NHWC
    rgb24 pipes even when ffmpeg is available — the pipe format follows
    the engine's layout."""
    p = EffectParams(scanline_strength=0.5, scanline_angle=12.0,
                     scanline_thickness=2.0, triad_strength=0.3,
                     bloom_strength=0.25, fast_bloom=True,
                     vignette_strength=0.2)
    clip = write_clip(tmp_path / "in.mp4", synth_frames(N, H, W, seed=9))

    nhwc_frames: list = []
    monkeypatch.setattr(
        vio, "open_writer",
        lambda *a, **k: (CollectWriter(nhwc_frames), False))
    process_video(clip, tmp_path / "o1.mp4", p, batch_size=4, report=False)

    fallback_frames: list = []
    seen = {}
    real_open_reader = vio.open_reader

    def spy_reader(src, w, h, fps, pref="auto", pipe_format="rgb24", **k):
        seen["pipe_format"] = pipe_format
        # no real ffmpeg here: serve frames via the cv2 reader (the
        # pipeline asked for rgb24 NHWC, which cv2 provides)
        assert pipe_format == "rgb24"
        return real_open_reader(src, w, h, fps, "cpu", pipe_format, **k)

    def spy_writer(*a, **k):
        seen["pix_fmt"] = k.get("pix_fmt")
        return CollectWriter(fallback_frames), False

    monkeypatch.setattr(vio, "find_ffmpeg", lambda: "/bin/ffmpeg")
    monkeypatch.setattr(vio, "extract_audio", lambda *a, **k: None)
    monkeypatch.setattr(vio, "open_reader", spy_reader)
    monkeypatch.setattr(vio, "open_writer", spy_writer)
    process_video(clip, tmp_path / "o2.mp4", p, batch_size=4, report=False)

    assert seen["pipe_format"] == "rgb24"
    assert seen["pix_fmt"] == "rgb24"
    np.testing.assert_array_equal(np.stack(fallback_frames),
                                  np.stack(nhwc_frames))
