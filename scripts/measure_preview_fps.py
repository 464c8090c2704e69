"""Measure the GUI live-preview tick rate: engine-backed vs oracle.

The engine-backed preview (gui_qt.render_preview_frame) claims
device-rate ticks after a per-preset compile; this script measures
them. Every tick uses a distinct t (distinct grain stream + aux), and
the np.asarray readback of the output frame is a real host fetch, so
per-tick time INCLUDES one host-to-device and one device-to-host copy
of a preview frame — exactly what a live preview pays per tick.

Usage: python scripts/measure_preview_fps.py [engine_ticks] [oracle_ticks]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pythoncrt_tpu import gui_qt  # noqa: E402
from pythoncrt_tpu.params import EffectParams  # noqa: E402

# a c3-class "heavy preset" (about 1 fps on the oracle path): bloom +
# warp + grain + grade + triad + scanlines
HEAVY = EffectParams(
    scanline_strength=0.6, triad_strength=0.35, triad_softness=0.5,
    aberration_px=1, bloom_sigma=1.2, bloom_strength=0.25,
    fast_bloom=False, noise_strength=1.5, vignette_strength=0.25,
    pixel_size=2, grain_size=2, warp_strength=0.15,
    flicker_strength=0.2, flicker_hz=2.0, brightness=0.02,
    contrast=1.05, gamma=1.1, saturation=0.9, temperature=0.1,
)


def tick_rate(frame, use_engine, n, t0=0.0):
    rng = np.random.default_rng(1234 + int(use_engine))
    times = []
    for i in range(n):
        # distinct t per tick (distinct grain + aux)
        t = t0 + 0.0337 * (i + 1) + float(rng.random()) * 1e-3
        start = time.perf_counter()
        out, _ = gui_qt.render_preview_frame(
            frame, HEAVY, t=t, use_engine=use_engine)
        assert out.dtype == np.uint8  # np.asarray readback already done
        times.append(time.perf_counter() - start)
    med = float(np.median(times))
    return 1.0 / med, med


def main():
    n_eng = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    n_ora = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    rng = np.random.default_rng(7)
    src = rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    pw, ph = gui_qt._preview_size(1920, 1080)
    print(f"preview size {pw}x{ph} (from 1920x1080)", flush=True)

    t_build = time.perf_counter()
    out, _ = gui_qt.render_preview_frame(src, HEAVY, t=0.01, use_engine=True)
    print(f"first engine tick (build+compile): "
          f"{time.perf_counter() - t_build:.1f}s", flush=True)
    # one more warm tick before timing (cache hit path)
    gui_qt.render_preview_frame(src, HEAVY, t=0.02, use_engine=True)

    fps_e, med_e = tick_rate(src, True, n_eng)
    print(f"engine-backed preview: {fps_e:.1f} fps "
          f"(median {med_e*1000:.1f} ms/tick, n={n_eng})", flush=True)

    fps_o, med_o = tick_rate(src, False, n_ora)
    print(f"oracle preview:        {fps_o:.2f} fps "
          f"(median {med_o*1000:.0f} ms/tick, n={n_ora})", flush=True)
    print(f"speedup: {fps_e / fps_o:.1f}x", flush=True)


if __name__ == "__main__":
    main()
