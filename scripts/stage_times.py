"""Device time per effect stage and per persistence form, on the GPU.

For each cell (config at its size and batch) this times, on device-
resident inputs:

- the whole engine step (wall clock per call around block_until_ready);
- each stage as its own jitted program — stages 1-11, bloom (6), warp
  (12), glitch (14) and persistence + uint8 cast (15) — with its device
  time summed from a jax.profiler trace and its share of the card's
  memory roofline (bytes the stage must move / peak bandwidth / time);
- the c4 step with each persistence form: lax.scan (the engine's),
  the associative scan and a fully unrolled scan.

    python scripts/stage_times.py [--out chiprun_out/stage_times.json]

Refuses to run on anything but a GPU. Prints one line per measurement
and writes them all as JSON.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# published peak memory bandwidth (bytes/s), keyed by device_kind
# (NVIDIA H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s)
PEAK_BW = {"NVIDIA H100 80GB HBM3": 3.35e12}


def device_busy_ns(xplane: str) -> float:
    """Busy time of GPU 0 in a trace: the union of the intervals of the
    events on its stream lines."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane)
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU:0"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            spans += [(e.start_ns, e.start_ns + e.duration_ns)
                      for e in line.events]
    spans.sort()
    busy, end = 0.0, -1.0
    for a, b in spans:
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def time_fn(fn, args, iters: int):
    """(wall ms per call, device ms per call) for a jitted fn."""
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    wall = (time.perf_counter() - t0) / iters * 1e3
    with tempfile.TemporaryDirectory(dir=os.environ.get("STAGE_TMP")) as td:
        with jax.profiler.trace(td):
            for _ in range(iters):
                out = fn(*args)
            jax.block_until_ready(out)
        xp = sorted(glob.glob(f"{td}/**/*.xplane.pb", recursive=True))[-1]
        dev = device_busy_ns(xp) / iters / 1e6
    return wall, dev


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/stage_times.json")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import config_params
    from pythoncrt_tpu.engine import CRTEngine
    from pythoncrt_tpu.ops import glitch as oglitch
    from pythoncrt_tpu.ops import warp as owarp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, JAX runs on {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    peak = PEAK_BW[dev.device_kind]
    print(f"device {dev.device_kind} | card {card}", flush=True)
    rows = []

    def record(cell, what, wall, devms, nbytes=None):
        r = {"cell": cell, "what": what, "wall_ms": round(wall, 4),
             "device_ms": round(devms, 4), "card": card}
        if nbytes:
            r["bytes"] = int(nbytes)
            r["roofline_share"] = round(nbytes / peak / (devms / 1e3), 4)
        rows.append(r)
        print(json.dumps(r), flush=True)

    cells = [
        ("c1", "c1_defaults_480p", 480, 640, 16),
        ("c2", "c2_retro_720p", 720, 1280, 16),
        ("c3", "c3_full_1080p", 1080, 1920, 16),
        ("c4", "c4_temporal_1080p", 1080, 1920, 16),
        ("c4_b32", "c4_temporal_1080p", 1080, 1920, 32),
        ("c5shape", "c4_temporal_1080p", 2160, 3840, 8),
    ]
    for cell, name, h, w, b in cells:
        p = config_params(name)
        n = h * w * 3  # elements per frame
        rng = np.random.default_rng(0)
        frames = jax.device_put(
            rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8))
        variants = [("scan", {})]
        if p.persistence_on:
            variants += [("assoc", {"assoc_scan": True}), ("unrolled", {})]
        for form, kw in variants:
            eng = CRTEngine(p, h, w, 30.0, **kw)
            if form == "unrolled":
                eng._finish = _unrolled_finish(eng)
            aux = jax.tree.map(jax.device_put, eng.make_aux(np.arange(b)))
            st = eng.init_state()
            first = jnp.zeros((1,), jnp.bool_)
            step = jax.jit(eng._step)
            wall, devms = time_fn(step, (frames, aux, st, first, eng._c),
                                  args.iters)
            what = "step" if not p.persistence_on else f"step[{form}]"
            record(cell, what, wall, devms, nbytes=2 * n * b)
            if form != "scan":
                continue
            c = eng._c
            chain = jax.jit(lambda fr, ax: jax.vmap(
                lambda im, a: eng._frame_post_bloom(
                    c, eng._frame_bloom_xla(c, im) if p.bloom_on else im, a)
            )(jax.vmap(lambda f, a: eng._frame_pre_bloom(c, f, a))(fr, ax),
              ax))
            record(cell, "stages_1_11", *time_fn(chain, (frames, aux),
                                                 args.iters), nbytes=5 * n * b)
            imgs = jax.jit(lambda fr, ax: eng._batch_effects(fr, ax, c))(
                frames, aux)
            if p.bloom_on:
                bloom = jax.jit(jax.vmap(lambda im: eng._frame_bloom_xla(c, im)))
                record(cell, "bloom_" + ("fast" if p.fast_bloom else "gauss"),
                       *time_fn(bloom, (imgs,), args.iters), nbytes=8 * n * b)
            if p.warp_on:
                warp = jax.jit(jax.vmap(
                    lambda im: owarp.bilinear_gather_const0(im, *c["warp"])))
                record(cell, "warp", *time_fn(warp, (imgs,), args.iters),
                       nbytes=8 * n * b)
            if p.glitch_on and eng._glitch_rows > 0:
                offs = jnp.asarray(rng.normal(
                    0, 4, (b, eng._glitch_rows, w)).astype(np.float32))
                glitch = jax.jit(jax.vmap(
                    lambda im, o: oglitch.shear_band(im, eng._glitch_y0, o)))
                record(cell, "glitch", *time_fn(glitch, (imgs, offs),
                                                args.iters), nbytes=8 * n * b)
            fin = jax.jit(lambda im, s, f: eng._finish(im, s, f))
            record(cell, "persist_u8" if p.persistence_on else "u8_cast",
                   *time_fn(fin, (imgs, st, first), args.iters),
                   nbytes=5 * n * b)
            if p.persistence_on:
                record(cell, "persist_u8[unrolled]",
                       *time_fn(jax.jit(_unrolled_finish(eng)),
                                (imgs, st, first), args.iters),
                       nbytes=5 * n * b)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(rows, fh, indent=1)


def _unrolled_finish(eng):
    """The engine's lax.scan persistence, fully unrolled over the batch."""
    import jax
    import jax.numpy as jnp

    from pythoncrt_tpu.ops import color as ocolor

    pp = np.float32(eng.params.persistence)
    om = np.float32(1.0 - eng.params.persistence)

    def finish(imgs, state, first_arr):
        out0 = jnp.where(first_arr[0], imgs[0],
                         jnp.clip(pp * state + om * imgs[0], 0.0, 1.0))

        def blend(prev, cur):
            b = jnp.clip(pp * prev + om * cur, 0.0, 1.0)
            return b, b

        _, rest = jax.lax.scan(blend, out0, imgs[1:], unroll=True)
        outs = jnp.concatenate([out0[None], rest], axis=0)
        return ocolor.to_uint8(outs), outs[-1]

    return finish


if __name__ == "__main__":
    main()
