"""End-to-end pipeline benchmark: decode scaling + full-render fps.

Three layers, reported separately:

1. decode-only throughput (ChunkedParallelReader, workers 1/2/4) —
   whether the host I/O ring scales toward the ~6 GB/s that
   1080p@1000fps needs (SURVEY.md §7 hard part 3);
2. full process_video fps (the perf report shows whether decode
   overlaps device time);
3. the engine-only fps for reference (bench.py's metric).

Usage: python scripts/bench_pipeline.py [--skip-render]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_clip(path, n, h, w, fps=30):
    import cv2

    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                         fps, (w, h))
    assert wr.isOpened()
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        f = ((xx + yy * 2 + 9 * i) % 256).astype(np.uint8)
        wr.write(np.stack([f, 255 - f, np.roll(f, i, 1)], -1))
    wr.release()
    return str(path)


def bench_decode(src, n, h, w, workers):
    from pythoncrt_tpu.io import video as vio

    if workers == 1:
        r = vio.open_reader(src, w, h, 30)
        buf = np.empty((n, h, w, 3), np.uint8)
        t0 = time.perf_counter()
        got = 0
        while got < n and r.read_into(buf[got]):
            got += 1
        dt = time.perf_counter() - t0
        r.close()
    else:
        r = vio.ChunkedParallelReader(src, w, h, 30, total_frames=n,
                                      batch_size=16, workers=workers)
        t0 = time.perf_counter()
        got = sum(b.shape[0] for _, b in r.iter_batches(16))
        dt = time.perf_counter() - t0
        r.close()
    mbps = got * h * w * 3 / dt / 1e6
    return got / dt, mbps


def main():
    import tempfile

    from pythoncrt_tpu.params import EffectParams
    from pythoncrt_tpu.pipeline import process_video

    skip_render = "--skip-render" in sys.argv
    td = tempfile.mkdtemp(prefix="pcrt_bench_")
    specs = [("480p", 240, 480, 640), ("1080p", 120, 1080, 1920)]
    clips = {}
    for name, n, h, w in specs:
        clips[name] = (make_clip(f"{td}/{name}.mp4", n, h, w), n, h, w)

    print("== decode-only (host I/O ring) ==", flush=True)
    for name, (src, n, h, w) in clips.items():
        bench_decode(src, n, h, w, 1)  # warm the page cache + codec
        for workers in (1, 2, 4):
            fps, mbps = bench_decode(src, n, h, w, workers)
            print(f"  {name} workers={workers}: {fps:7.1f} fps "
                  f"({mbps:7.0f} MB/s RGB)", flush=True)

    if skip_render:
        return
    print("== full pipeline ==", flush=True)
    p = EffectParams(scanline_strength=0.6, vignette_strength=0.25,
                     triad_strength=0.0, aberration_px=0, bloom_strength=0.0,
                     noise_strength=0.0, persistence=0.0, pixel_size=1)
    from pythoncrt_tpu import perf

    for name, (src, n, h, w) in clips.items():
        for workers in (1, 2):
            # cold run compiles; the warm second run is the pipeline
            process_video(src, f"{td}/out_{name}_{workers}.mp4", p,
                          batch_size=16, decode_workers=workers, report=False)
            perf.perf_reset()
            t0 = time.perf_counter()
            process_video(src, f"{td}/out_{name}_{workers}.mp4", p,
                          batch_size=16, decode_workers=workers, report=False)
            dt = time.perf_counter() - t0
            tot = perf.snapshot()
            dec = tot.get("io.decode", (0.0, 0))[0]
            wait = tot.get("fx.device_wait", (0.0, 0))[0]
            disp = tot.get("fx.dispatch", (0.0, 0))[0]
            print(f"  {name} c1-ish decode_workers={workers}: "
                  f"{n / dt:6.1f} fps end-to-end (warm; decode {dec:.2f}s"
                  f" vs device {disp + wait:.2f}s of {dt:.2f}s)", flush=True)


if __name__ == "__main__":
    main()
