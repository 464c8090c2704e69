"""Stage ablation at the engine level: measure full-config fps on the
GPU, then fps with one stage disabled at a time; the delta is the
stage cost.
The all-off config is the framework floor (u8 entry/exit + dispatch).

Usage: python scripts/ablate.py [c3|c4] [--iters N]
"""

from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import bench_engine, config_params  # noqa: E402

H, W, B = 1080, 1920, 32

ABLATIONS_C3 = {
    "warp": dict(warp_strength=0.0),
    "bloom": dict(bloom_strength=0.0),
    "pixelate": dict(pixel_size=1),
    "grade": dict(brightness=0.0, contrast=1.0, gamma=1.0, saturation=1.0,
                  temperature=0.0),
    "noise": dict(noise_strength=0.0),
    "triad": dict(triad_strength=0.0),
    "scanlines": dict(scanline_strength=0.0),
    "vignette": dict(vignette_strength=0.0),
    "flicker": dict(flicker_strength=0.0),
    "aberration": dict(aberration_px=0),
}

ABLATIONS_C4 = {
    "fast_bloom": dict(bloom_strength=0.0),
    "glitch": dict(glitch_amp_px=0, glitch_height_frac=0.0),
    "persistence": dict(persistence=0.0),
    "noise": dict(noise_strength=0.0),
    "triad": dict(triad_strength=0.0),
    "scanlines": dict(scanline_strength=0.0),
    "aberration": dict(aberration_px=0),
    "vignette": dict(vignette_strength=0.0),
}

ALL_OFF = dict(
    scanline_strength=0.0, triad_strength=0.0, vignette_strength=0.0,
    noise_strength=0.0, bloom_strength=0.0, persistence=0.0,
    aberration_px=0, pixel_size=1, warp_strength=0.0, flicker_strength=0.0,
    glitch_amp_px=0, glitch_height_frac=0.0,
    brightness=0.0, contrast=1.0, gamma=1.0, saturation=1.0, temperature=0.0,
)


def main() -> None:
    cfg = "c3"
    iters = 10
    for i, a in enumerate(sys.argv):
        if a in ("c3", "c4"):
            cfg = a
        if a == "--iters":
            iters = int(sys.argv[i + 1])
    base_name = "c3_full_1080p" if cfg == "c3" else "c4_temporal_1080p"
    abls = ABLATIONS_C3 if cfg == "c3" else ABLATIONS_C4
    base = config_params(base_name)

    fps0, comp, _ = bench_engine(base, H, W, B, iters)
    full_ms = 1000.0 / fps0
    print(f"{cfg} full: {fps0:.1f} fps = {full_ms:.3f} ms/f "
          f"(compile {comp:.0f}s)", flush=True)

    total = 0.0
    for name, over in abls.items():
        p = dataclasses.replace(base, **over)
        fps, _, _ = bench_engine(p, H, W, B, iters)
        d = full_ms - 1000.0 / fps
        total += max(0.0, d)
        print(f"  -{name:12s} {fps:7.1f} fps   stage ~{d:6.3f} ms/f", flush=True)

    p_off = dataclasses.replace(base, **ALL_OFF)
    fps_off, _, _ = bench_engine(p_off, H, W, B, iters)
    floor = 1000.0 / fps_off
    print(f"  all-off floor: {fps_off:.1f} fps = {floor:.3f} ms/f", flush=True)
    print(f"  sum(stages) {total:.3f} + floor {floor:.3f} = "
          f"{total + floor:.3f} vs full {full_ms:.3f} "
          f"(residual {full_ms - total - floor:.3f})", flush=True)


if __name__ == "__main__":
    main()
