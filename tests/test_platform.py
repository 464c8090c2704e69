"""Platform rules that keep the device visible: the compile-cache
directory, the no-accelerator refusals of bench.py and chip_smoke.py,
chip_smoke.py's phase selection and result line, the ffmpeg-only clip
probe, and the reported fallback of the GUI preview."""

import dataclasses
import json
import os
import sys
import types

import jax
import numpy as np
import pytest

from pythoncrt_tpu import engine as em
from pythoncrt_tpu.io import video as vio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


@pytest.fixture
def cache_config():
    """Restore JAX's compile-cache setting after a test changes it."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_dir_is_fixed_in_checkout():
    assert em.COMPILE_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_compile_cache_repo_dir_on_gpu(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    em._enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == em.COMPILE_CACHE_DIR


def test_compile_cache_env_dir_left_to_jax(monkeypatch, cache_config,
                                           tmp_path):
    """JAX reads JAX_COMPILATION_CACHE_DIR itself; the engine sets no
    other directory."""
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    em._enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_off_on_cpu(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    em._enable_compile_cache()
    assert jax.default_backend() == "cpu"
    assert jax.config.jax_compilation_cache_dir == before


FFMPEG_STDERR = """Input #0, mov,mp4,m4a,3gp,3g2,mj2, from 'in.mp4':
  Duration: 00:00:02.00, start: 0.000000, bitrate: 9 kb/s
  Stream #0:0[0x1](und): Video: mpeg4 (Simple Profile) (mp4v / 0x7634706D), yuv420p, 1920x1080 [SAR 1:1 DAR 16:9], 8 kb/s, 23.98 fps, 23.98 tbr, 24k tbn (default)
Output #0, null, to 'pipe:':
frame=   12 fps=0.0 q=-1.0 size=N/A time=00:00:00.50 bitrate=N/A speed=20x
frame=   48 fps=0.0 q=-1.0 Lsize=N/A time=00:00:02.00 bitrate=N/A speed=90x
"""


def _no_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import raises


def test_probe_clip_without_cv2(monkeypatch):
    _no_cv2(monkeypatch)
    seen = {}

    def fake_run(cmd, **kw):
        seen["cmd"] = cmd
        return types.SimpleNamespace(returncode=0, stderr=FFMPEG_STDERR)

    monkeypatch.setattr(vio, "find_ffmpeg", lambda: "/bin/ffmpeg")
    monkeypatch.setattr(vio.subprocess, "run", fake_run)
    info = vio.probe_clip("in.mp4")
    assert info == vio.ClipInfo(width=1920, height=1080, fps=23.98,
                                frame_count=48)
    # stream copy to the null muxer: counted, not decoded
    assert seen["cmd"][0] == "/bin/ffmpeg"
    assert seen["cmd"][seen["cmd"].index("-c") + 1] == "copy"


def test_probe_clip_ffmpeg_unreadable(monkeypatch):
    _no_cv2(monkeypatch)
    monkeypatch.setattr(vio, "find_ffmpeg", lambda: "/bin/ffmpeg")
    monkeypatch.setattr(vio.subprocess, "run", lambda *a, **k: (
        types.SimpleNamespace(returncode=1, stderr="x.mp4: Invalid data")))
    with pytest.raises(FileNotFoundError):
        vio.probe_clip("x.mp4")


def test_probe_clip_needs_cv2_or_ffmpeg(monkeypatch):
    _no_cv2(monkeypatch)
    monkeypatch.setattr(vio, "find_ffmpeg", lambda: None)
    with pytest.raises(RuntimeError, match="OpenCV or an ffmpeg"):
        vio.probe_clip("x.mp4")


def test_gui_preview_build_failure_reported(monkeypatch, capsys):
    """A failed preview-engine build falls back to the oracle and says
    so on stderr, once."""
    from pythoncrt_tpu import gui_qt
    from pythoncrt_tpu.params import EffectParams

    def boom(*a, **k):
        raise RuntimeError("no device memory")

    monkeypatch.setattr(em, "CRTEngine", boom)
    monkeypatch.setattr(gui_qt, "_PREVIEW_ENGINES", {})
    monkeypatch.setattr(gui_qt, "_PREVIEW_REPORTED", set())
    frame = np.full((32, 48, 3), 128, np.uint8)
    p = EffectParams(scanline_strength=0.5, noise_strength=0.0)
    for t in (0.0, 0.1):
        out, _ = gui_qt.render_preview_frame(frame, p, t, use_engine=True)
        assert out.shape == (32, 48, 3)
    err = capsys.readouterr().err
    assert err.count("preview engine build failed") == 1
    assert "no device memory" in err


def test_bench_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        bench.require_gpu()
    assert e.value.code == 2
    assert "cpu" in capsys.readouterr().err


def test_chip_smoke_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def _fake_smoke(monkeypatch, count):
    calls = []
    monkeypatch.setattr(chip_smoke, "device_check", lambda n: calls.append(
        ("device_check", n)) or {"platform": "gpu", "kind": "FakeGPU",
                                 "count": count})
    for name in ("phase_parity", "phase_served", "phase_batch",
                 "four_card_phase"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    return calls


def test_chip_smoke_result_line(monkeypatch, capsys):
    calls = _fake_smoke(monkeypatch, 1)
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {
        "ok": True, "device": {"platform": "gpu", "kind": "FakeGPU",
                               "count": 1}}
    assert calls == [("device_check", 1), "phase_parity", "phase_served",
                     "phase_batch"]
    assert not os.path.exists(chip_smoke.WORK)


def test_chip_smoke_four_runs_only_mesh_phase(monkeypatch, capsys):
    calls = _fake_smoke(monkeypatch, 4)
    assert chip_smoke.main(["--four"]) == 0
    assert calls == [("device_check", 4), "four_card_phase"]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"]["count"] == 4


def test_chip_smoke_failing_phase_prints_no_result(monkeypatch, capsys):
    _fake_smoke(monkeypatch, 1)

    def fail():
        raise RuntimeError("parity above 1 LSB")

    monkeypatch.setattr(chip_smoke, "phase_served", fail)
    with pytest.raises(RuntimeError):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out
    assert not os.path.exists(chip_smoke.WORK)


@pytest.mark.parametrize("flags,name", [
    (chip_smoke.C3_FLAGS, "c3_full_1080p"),
    (chip_smoke.C4_FLAGS, "c4_temporal_1080p")])
def test_chip_smoke_flags_are_the_configs(flags, name):
    """The CLI flags the served and batch phases pass give exactly the
    benchmark's config parameters (an empty text overlay aside)."""
    from pythoncrt_tpu import cli

    argv = ["--input", "x.mp4"] + flags
    got = cli.params_from_args(cli.build_parser().parse_args(argv),
                               cli.provided_flags(argv)).clamped()
    want = bench.config_params(name).clamped()
    assert not got.text.enabled and not want.text.enabled
    assert dataclasses.replace(got, text=want.text) == want
