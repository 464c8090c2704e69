"""Dependency-check bootstrap (reference crt_filter.py:17-47, redesigned
as an explicit diagnostic instead of an import-time pip install)."""

from pythoncrt_tpu.bootstrap import check_deps
from pythoncrt_tpu.cli import main


def test_core_deps_present_here():
    rep = check_deps()
    assert rep.ok, rep.render()


def test_report_mentions_optional_pyside(capsys):
    rc = main(["--check-deps"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "PySide6" in out or "all dependencies present" in out


def test_missing_core_dep_fails_with_guidance(monkeypatch, capsys):
    """Without an ffmpeg binary, OpenCV is the video I/O and required."""
    import importlib.util

    import pythoncrt_tpu.bootstrap as bs
    from pythoncrt_tpu.io import video as vio

    monkeypatch.setattr(vio, "find_ffmpeg", lambda: None)
    real = importlib.util.find_spec

    def fake(name, *a, **k):
        return None if name == "cv2" else real(name, *a, **k)

    monkeypatch.setattr(bs.importlib.util, "find_spec", fake)
    rep = bs.check_deps()
    assert not rep.ok
    assert "opencv-python-headless" in rep.render()
    rc = main(["--check-deps"])
    assert rc == 4
    assert "MISSING (required): cv2" in capsys.readouterr().out


def test_opencv_optional_with_ffmpeg(monkeypatch):
    """With an ffmpeg binary, OpenCV is optional: its absence is
    reported, not fatal."""
    import importlib.util

    import pythoncrt_tpu.bootstrap as bs
    from pythoncrt_tpu.io import video as vio

    monkeypatch.setattr(vio, "find_ffmpeg", lambda: "/bin/ffmpeg")
    real = importlib.util.find_spec
    monkeypatch.setattr(bs.importlib.util, "find_spec", lambda name, *a, **k:
                        None if name == "cv2" else real(name, *a, **k))
    rep = bs.check_deps()
    assert rep.ok
    assert "missing (optional): cv2" in rep.render()
