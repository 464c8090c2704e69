#!/usr/bin/env python3
"""Smoke test of the renderer on NVIDIA GPUs: the quickest proof that
the system still starts, renders and agrees with its reference on the
card.

    python3 chip_smoke.py           # phases 1-4 on one card
    python3 chip_smoke.py --four    # the four-card phase only

Phases (one process holds the card; the CLI runs in-process through
pythoncrt_tpu.cli.main):

  1. device check: the JAX devices, their kind, and the card's name and
     power limit as nvidia-smi reports them. Anything but a GPU fails.
  2. parity: the engine against the CPU oracle (pythoncrt_tpu.oracle,
     host-rng noise and glitch fields) for configs c1-c4 at full size
     and the c4 parameters at 3840x2160 (c5's shape): <= 1 LSB per
     channel after the uint8 round trip.
  3. served path: a seeded 1080p clip through `--input ... --output ...`
     with the c3 flags; exit 0, the input's frame count, and a vignette
     (corners darker than the center).
  4. batch path: `--batch-manifest` with two 1080p clips of different
     lengths and the c4 flags (persistence, glitch); both ok, both keep
     their frame counts.

--four runs only the multi-card phase on four cards: c5 (8 clips at
3840x2160, text after effects) clip-sharded through process_videos, and
a 1080p clip with persistence frame-sharded through process_video (the
carry crosses devices by ppermute). Each is compared with the same
engine on one card in the same process: clip sharding bitwise, frame
sharding <= 1 LSB (its carry composes in another f32 order).

Any failure exits non-zero and prints no result. The last line of
stdout is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_run")  # clips and renders; removed at exit

C3_FLAGS = [
    "--scanline-strength", "0.6", "--triad-strength", "0.35",
    "--triad-softness", "0.5", "--aberration-px", "1",
    "--bloom-sigma", "1.2", "--bloom-strength", "0.25", "--no-fast-bloom",
    "--noise-strength", "1.5", "--vignette-strength", "0.25",
    "--persistence", "0", "--pixel-size", "2", "--grain-size", "2",
    "--warp-strength", "0.15", "--flicker-strength", "0.2",
    "--flicker-hz", "2", "--brightness", "0.02", "--contrast", "1.05",
    "--gamma", "1.1", "--saturation", "0.9", "--temperature", "0.1",
]
C4_FLAGS = [
    "--scanline-strength", "0.6", "--triad-strength", "0.35",
    "--aberration-px", "1", "--bloom-strength", "0.25", "--fast-bloom",
    "--noise-strength", "1.5", "--vignette-strength", "0.25",
    "--persistence", "0.6", "--pixel-size", "1", "--glitch-amp", "6",
    "--glitch-height", "0.3", "--scanline-speed", "120",
]

# (config, height, width) for the parity phase
PARITY = [
    ("c1_defaults_480p", 480, 640),
    ("c2_retro_720p", 720, 1280),
    ("c3_full_1080p", 1080, 1920),
    ("c4_temporal_1080p", 1080, 1920),
    ("c4_temporal_1080p", 2160, 3840),
]


def log(*a) -> None:
    print(*a, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card phase")
    return p.parse_args(argv)


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def device_check(count: int):
    """Phase 1. Returns the device record of the result line."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {devs[0].platform!r}; this smoke test "
            "measures nothing on another backend")
    if len(devs) < count:
        raise RuntimeError(f"need {count} GPUs, JAX sees {len(devs)}")
    log(f"devices: {devs}")
    log(f"device_kind: {devs[0].device_kind}")
    for ln in card_lines():
        log(ln)  # name, power limit — as nvidia-smi prints them
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def synth_frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """Seeded test content: gradients, a checkerboard, impulses on black
    and random texture, cycling per frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        kind = i % 4
        if kind == 0:
            f = (xx + yy + 7 * i) % 256
            out[i] = np.stack([f, 255 - f, (2 * f) % 256], -1)
        elif kind == 1:
            out[i] = (((xx // 8 + yy // 8 + i) % 2) * 255)[..., None]
        elif kind == 2:
            out[i] = 0
            pts = rng.integers(0, [h, w], size=(64, 2))
            out[i][pts[:, 0], pts[:, 1]] = 255
        else:
            out[i] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return out


def phase_parity(configs=PARITY) -> None:
    """Phase 2."""
    from bench import config_params
    from pythoncrt_tpu.engine import CRTEngine
    from pythoncrt_tpu.oracle import render_oracle

    b = 4
    log("parity vs oracle (uint8, rng=host):")
    bad = []
    for name, h, w in configs:
        eng = CRTEngine(config_params(name), h, w, 30.0, rng="host")
        frames = synth_frames(b, h, w, seed=h + w)
        got = np.asarray(eng.process(frames)[0])
        want = render_oracle(eng, frames)
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        log(f"  {name:18s} {w}x{h} B={b}: max_err={int(d.max())} "
            f"frac>0={float((d > 0).mean()):.3e}")
        if d.max() > 1:
            bad.append(name)
    if bad:
        raise RuntimeError(f"parity above 1 LSB: {bad}")


def write_clip(path: str, frames: np.ndarray, fps: float = 24.0) -> str:
    import cv2

    h, w = frames.shape[1:3]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not wr.isOpened():
        raise RuntimeError(f"cannot write {path}")
    for f in frames:
        wr.write(np.ascontiguousarray(f[..., ::-1]))
    wr.release()
    return path


def smooth_frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """Mid-gray content with a moving texture: the vignette shows as a
    clear corner/center ratio."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((n, h, w, 3), np.uint8)
    tint = rng.uniform(-10, 10, 3)
    for i in range(n):
        v = 150 + 30 * np.sin((xx + 5 * i) / 37.0) * np.cos(yy / 29.0)
        out[i] = np.clip(v[..., None] + tint, 0, 255).astype(np.uint8)
    return out


def corner_center_ratio(frame: np.ndarray) -> float:
    h, w = frame.shape[:2]
    corners = np.concatenate([frame[:16, :16], frame[:16, -16:],
                              frame[-16:, :16], frame[-16:, -16:]])
    center = frame[h // 2 - 16:h // 2 + 16, w // 2 - 16:w // 2 + 16]
    return float(corners.mean()) / max(1e-6, float(center.mean()))


def read_first_frame(path: str) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(path)
    ok, f = cap.read()
    cap.release()
    if not ok:
        raise RuntimeError(f"cannot decode {path}")
    return f


def phase_served(h: int = 1080, w: int = 1920, n: int = 48) -> None:
    """Phase 3."""
    from pythoncrt_tpu import cli
    from pythoncrt_tpu.io.video import probe_clip

    src = write_clip(os.path.join(WORK, "served_in.mp4"),
                     smooth_frames(n, h, w, seed=4))
    dst = os.path.join(WORK, "served_out.mp4")
    t0 = time.perf_counter()
    rc = cli.main(["--input", src, "--output", dst] + C3_FLAGS)
    secs = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"served path exited {rc}")
    n_in, n_out = probe_clip(src).frame_count, probe_clip(dst).frame_count
    r_in = corner_center_ratio(read_first_frame(src))
    r_out = corner_center_ratio(read_first_frame(dst))
    log(f"served path c3 {w}x{h}: rc={rc} frames {n_in}->{n_out} "
        f"corner/center {r_in:.3f}->{r_out:.3f} ({secs:.1f}s incl. compile)")
    if n_out != n_in or n_in != n:
        raise RuntimeError("served path changed the frame count")
    if not r_out < 0.9 * r_in:
        raise RuntimeError("no vignette signature in the served output")


def phase_batch(h: int = 1080, w: int = 1920, lengths=(40, 24)) -> None:
    """Phase 4."""
    from pythoncrt_tpu import cli
    from pythoncrt_tpu.io.video import probe_clip

    jobs = []
    for i, n in enumerate(lengths):
        src = write_clip(os.path.join(WORK, f"batch_in{i}.mp4"),
                         synth_frames(n, h, w, seed=20 + i))
        jobs.append({"input": src,
                     "output": os.path.join(WORK, f"batch_out{i}.mp4")})
    manifest = os.path.join(WORK, "jobs.json")
    with open(manifest, "w") as fh:
        json.dump(jobs, fh)
    t0 = time.perf_counter()
    rc = cli.main(["--batch-manifest", manifest, "--batch-journal", "none"]
                  + C4_FLAGS)
    secs = time.perf_counter() - t0
    counts = [probe_clip(j["output"]).frame_count for j in jobs]
    log(f"batch path c4 2x{w}x{h}: rc={rc} frames {list(lengths)}->"
        f"{counts} ({secs:.1f}s incl. compile)")
    if rc != 0 or counts != list(lengths):
        raise RuntimeError("batch path failed or changed frame counts")


class _Collector:
    """In-memory encoder sink: keeps the raw uint8 frames the pipeline
    hands to the encoder, so two runs compare byte for byte."""

    store: dict = {}

    def __init__(self, path: str):
        self.frames = _Collector.store.setdefault(path, [])

    def write_frame(self, f) -> None:
        self.frames.append(np.array(f))

    def close(self) -> None:
        pass


def _collect_outputs():
    from pythoncrt_tpu.io import video as vio

    vio.open_writer = lambda path, *a, **k: (_Collector(str(path)), False)
    vio.extract_audio = lambda *a, **k: None


def four_card_phase(n_dev: int = 4, clip_hw=(2160, 3840), clip_frames=8,
                    n_clips=8, seq_hw=(1080, 1920), seq_frames=64) -> None:
    """c5 clip-sharded and one clip frame-sharded on n_dev devices, each
    against the same engine on one device in the same process."""
    import jax

    from bench import config_params
    from pythoncrt_tpu import TextParams
    from pythoncrt_tpu.multiclip import process_videos
    from pythoncrt_tpu.pipeline import process_video

    _collect_outputs()
    store = _Collector.store
    p5 = dataclasses.replace(config_params("c4_temporal_1080p"),
                             text=TextParams(text="CRT 4K", after=True))
    h, w = clip_hw
    ins = [write_clip(os.path.join(WORK, f"c5_in{i}.mp4"),
                      synth_frames(clip_frames, h, w, seed=50 + i))
           for i in range(n_clips)]
    seq = write_clip(os.path.join(WORK, "seq_in.mp4"),
                     synth_frames(seq_frames, *seq_hw, seed=77))

    def run_c5(ndev: int) -> list:
        outs = [os.path.join(WORK, f"c5_out{i}_{ndev}.mp4")
                for i in range(n_clips)]
        t0 = time.perf_counter()
        res = process_videos(ins, outs, p5, devices=ndev, batch_size=8,
                             report=False)
        log(f"  c5 {n_clips}x{w}x{h} on {ndev} device(s): "
            f"{time.perf_counter() - t0:.1f}s incl. compile")
        if not all(r.ok for r in res):
            raise RuntimeError(f"c5 clip failed: {[r.error for r in res]}")
        return [np.stack(store[o]) for o in outs]

    def run_seq(sharding: str, ndev: int) -> np.ndarray:
        out = os.path.join(WORK, f"seq_out_{sharding}.mp4")
        t0 = time.perf_counter()
        process_video(seq, out, config_params("c4_temporal_1080p"),
                      batch_size=16, sharding=sharding, devices=ndev,
                      report=False)
        log(f"  1 clip {seq_hw[1]}x{seq_hw[0]} persistence, sharding="
            f"{sharding}: {time.perf_counter() - t0:.1f}s incl. compile")
        return np.stack(store[out])

    log(f"four-card phase ({n_dev} devices):")
    multi = run_c5(n_dev)
    sharded = run_seq("auto", n_dev)
    # None on backends without allocator stats (a CPU rehearsal)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.devices()[:n_dev]]
    log(f"  peak bytes per device: {peaks}")
    single = run_c5(1)
    plain = run_seq("none", 1)
    for i, (a, b) in enumerate(zip(multi, single)):
        if a.shape != b.shape or not np.array_equal(a, b):
            raise RuntimeError(f"c5 clip {i}: clip-sharded != one device")
    log(f"  c5 clip-sharded vs one device: bitwise equal "
        f"({n_clips} clips x {multi[0].shape[0]} frames)")
    d = np.abs(sharded.astype(np.int32) - plain.astype(np.int32))
    log(f"  frame-sharded vs one device: frames {sharded.shape[0]} "
        f"max_err={int(d.max())} frac>0={float((d > 0).mean()):.3e}")
    if sharded.shape != plain.shape or d.max() > 1:
        raise RuntimeError("frame-sharded render differs by more than 1 LSB")
    if jax.devices()[0].platform == "gpu" and not all(peaks):
        raise RuntimeError(f"a device held nothing: {peaks}")


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        dev = device_check(4 if args.four else 1)
    except Exception as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        if args.four:
            four_card_phase()
        else:
            phase_parity()
            phase_served()
            phase_batch()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
