"""Headline benchmark: 1080p frames/sec on one GPU, full effect stack
(BASELINE.json config 3), vs the CPU reference path.

Prints ONE JSON line on stdout:
  {"metric": "...", "value": N, "unit": "fps", "vs_baseline": N}
and the device (platform, device_kind, count, card name and power
limit) on stderr. Refuses to run on anything but a GPU.

vs_baseline = GPU fps / CPU-oracle fps on the identical config (the
oracle reproduces the reference chain; the upstream repo publishes no
numbers of its own — BASELINE.md).

Usage: python bench.py [--quick] [--all]
  --quick: small frames / few iters (CI smoke)
  --all:   also print per-config results for BASELINE configs 1-5 to stderr
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# Pinned CPU baselines (fps) for the vs_baseline ratios: the REAL
# reference's apply_static_effects + orchestrator drain, measured on an
# earlier development host via `scripts/bench_reference.py --all`
# (best-of-2). Pinning stops vs_baseline from tracking host load; the
# live oracle is still measured and logged, and if it ever beats the
# pin the larger (more conservative) denominator is used. These are the
# reference's BEST case — moviepy decode/encode overhead is excluded on
# every config — so the ratios are conservative.
PINNED_CPU_BASELINE = {
    "c1_defaults_480p": 108.26,   # 640x480
    "c2_retro_720p": 12.52,       # 1280x720
    "c3_full_1080p": 1.83,        # 1920x1080 (2026-08-17 remeasure; was 1.19)
    "c4_temporal_1080p": 2.51,    # 1920x1080
}
PINNED_CPU_BASELINE_FPS = PINNED_CPU_BASELINE["c3_full_1080p"]


def make_frames(b, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3), dtype=np.uint8)


def require_gpu():
    """Exit unless JAX runs on a GPU; log the device on stderr."""
    import subprocess

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"bench.py measures the GPU; JAX runs on {devs[0].platform}")
        raise SystemExit(2)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    log(f"platform: {devs[0].platform}, device_kind: {devs[0].device_kind}, "
        f"count: {len(devs)}, card: {card}")


def bench_engine(params, h, w, batch, iters, warmup=2, assoc_scan=False):
    """Device-resident engine throughput: frames and aux pre-staged on
    the device, outputs stay there (block_until_ready forces completion
    without a device->host copy). Each step's uint8 output feeds the
    next step, so the calls serialize.

    Dispatch batching: n sequential chunks scanned inside ONE dispatch
    (engine.jitted_multi_step), as pipeline.py's steps_per_call does
    (PCRT_BENCH_SPC overrides the default 8).
    """
    import os

    import jax
    import jax.numpy as jnp

    from pythoncrt_tpu.engine import CRTEngine

    eng = CRTEngine(params, h, w, fps=30.0, assoc_scan=assoc_scan)
    spc = int(os.environ.get("PCRT_BENCH_SPC", "8"))
    staged = make_frames(spc * batch, h, w)
    aux_np = eng.make_aux(np.arange(spc * batch))
    t0 = time.perf_counter()
    if spc > 1:
        staged = staged.reshape((spc, batch) + staged.shape[1:])
        aux = jax.tree.map(
            lambda a: jax.device_put(
                jnp.reshape(a, (spc, batch) + a.shape[1:])), aux_np)
        step = eng.jitted_multi_step()
    else:
        aux = jax.tree.map(jax.device_put, aux_np)
        step = eng.jitted_step()
    frames = jax.block_until_ready(jax.device_put(staged))
    stage_s = time.perf_counter() - t0
    state = eng.init_state()
    first = jnp.zeros((1,), jnp.bool_)

    t0 = time.perf_counter()
    out, _ = step(frames, aux, state, first, eng._c)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0
    cur = out
    for _ in range(max(2, warmup)):
        cur, _ = step(cur, aux, state, first, eng._c)
    jax.block_until_ready(cur)
    t0 = time.perf_counter()
    for _ in range(iters):
        cur, _ = step(cur, aux, state, first, eng._c)
    jax.block_until_ready(cur)
    dt = time.perf_counter() - t0
    return spc * batch * iters / dt, compile_s, stage_s


def bench_oracle(params, h, w, n_frames):
    from pythoncrt_tpu import oracle

    p = params.clamped()
    frames = make_frames(n_frames, h, w)
    triad = oracle.triad_mask(h, w, p.triad_strength, p.triad_softness) if p.triad_on else None
    vig = oracle.vignette_mask(h, w, p.vignette_strength) if p.vignette_on else None
    noise = (
        np.random.default_rng(0).standard_normal(
            (max(1, h // p.grain_size), max(1, w // p.grain_size)), dtype=np.float32
        )
        if p.noise_on
        else None
    )
    # warmup (allocator/cache effects made the first frame ~2x noisier)
    oracle.apply_effects(
        frames[0], p, phase_px=0.0, time_sec=0.0,
        triad=triad, vignette=vig, noise_field=noise,
    )

    def one_pass():
        prev = None
        t0 = time.perf_counter()
        for i in range(n_frames):
            img = oracle.apply_effects(
                frames[i], p, phase_px=i * 1.25, time_sec=i / 30.0,
                triad=triad, vignette=vig, noise_field=noise,
            )
            img = oracle.persistence_blend(prev, img, p.persistence)
            prev = img
            oracle.ops.to_uint8(img)
        return n_frames / (time.perf_counter() - t0)

    # best of 2: the max is the host's actual capability under shared
    # load, and the conservative choice for the vs_baseline ratio
    return max(one_pass(), one_pass())


def bench_c5(quick=False, iters=3):
    """Config 5: multi-clip batch render through the clip-sharded engine
    (on however many GPUs are visible), dispatched through
    process_stack's multi-chunk scan with the production auto
    steps-per-call (PCRT_BENCH_SPC_C5 overrides)."""
    import os

    import jax
    import jax.numpy as jnp

    from pythoncrt_tpu.engine import CRTEngine
    from pythoncrt_tpu.parallel import MultiClipEngine, make_mesh

    h, w, c, b = (540, 960, 2, 8) if quick else (2160, 3840, 4, 8)
    mesh = make_mesh(axis="clips")
    # clip count must be a multiple of the mesh size (the loop calls
    # _step/_mstep directly, bypassing process()'s divisibility check)
    ndev = mesh.devices.size
    c = -(-max(c, ndev) // ndev) * ndev
    eng = CRTEngine(config_params("c4_temporal_1080p"), h, w, fps=30.0)
    mc = MultiClipEngine(eng, mesh)
    spc = int(os.environ.get("PCRT_BENCH_SPC_C5", "0"))
    if spc <= 0:
        from pythoncrt_tpu.multiclip import auto_steps_per_call

        spc = auto_steps_per_call(h, w, c, b)
    staged = make_frames(spc * c * b, h, w)
    aux_np = eng.make_aux(np.tile(np.arange(spc * b).reshape(spc, 1, b),
                                  (1, c, 1)).reshape(-1))
    states = jnp.zeros((c,) + eng.init_state().shape, jnp.float32)
    first = jnp.full((1,), True, jnp.bool_)
    later = jnp.full((1,), False, jnp.bool_)
    if spc > 1:
        clips = jax.device_put(
            staged.reshape((spc, c * b) + staged.shape[1:]))
        aux = jax.tree.map(
            lambda a: jax.device_put(
                jnp.reshape(a, (spc, c * b) + a.shape[1:])), aux_np)
        step = mc._mstep
    else:
        clips = jax.device_put(staged)
        aux = jax.tree.map(jax.device_put, aux_np)
        step = mc._step
    out, st = step(clips, aux, states, first, eng._c)
    for _ in range(3):
        out, st = step(clips, aux, st, later, eng._c)
    jax.block_until_ready(out)
    # thread the state: each call consumes the previous call's carry
    t0 = time.perf_counter()
    for _ in range(iters):
        out, st = step(clips, aux, st, later, eng._c)
    jax.block_until_ready(out)
    return spc * c * b * iters / (time.perf_counter() - t0)


def config_params(name):
    from pythoncrt_tpu.params import EffectParams

    if name == "c1_defaults_480p":  # scanlines + vignette only
        return EffectParams(
            scanline_strength=0.6, vignette_strength=0.25, triad_strength=0.0,
            aberration_px=0, bloom_strength=0.0, noise_strength=0.0,
            persistence=0.0, pixel_size=1, fast_bloom=False,
        )
    if name == "c2_retro_720p":  # scanlines + triad + aberration + noise
        return EffectParams(
            scanline_strength=0.6, triad_strength=0.35, aberration_px=2,
            noise_strength=4.0, vignette_strength=0.0, bloom_strength=0.0,
            persistence=0.0, pixel_size=1, fast_bloom=False,
        )
    if name == "c3_full_1080p":  # full stack: gaussian bloom, warp, flicker, grain, grade
        return EffectParams(
            scanline_strength=0.6, triad_strength=0.35, triad_softness=0.5,
            aberration_px=1, bloom_sigma=1.2, bloom_strength=0.25,
            fast_bloom=False, noise_strength=1.5, vignette_strength=0.25,
            persistence=0.0, pixel_size=2, grain_size=2, warp_strength=0.15,
            flicker_strength=0.2, flicker_hz=2.0, brightness=0.02,
            contrast=1.05, gamma=1.1, saturation=0.9, temperature=0.1,
        )
    if name == "c4_temporal_1080p":  # persistence + glitch + animated roll
        return EffectParams(
            scanline_strength=0.6, triad_strength=0.35, aberration_px=1,
            bloom_strength=0.25, fast_bloom=True, noise_strength=1.5,
            vignette_strength=0.25, persistence=0.6, pixel_size=1,
            glitch_amp_px=6, glitch_height_frac=0.3, scanline_speed_px_s=120.0,
        )
    raise KeyError(name)


def main():
    quick = "--quick" in sys.argv
    run_all = "--all" in sys.argv
    if quick:
        h, w, batch, iters, oracle_frames = 270, 480, 32, 10, 2
    else:
        h, w, batch, iters, oracle_frames = 1080, 1920, 32, 10, 4

    require_gpu()

    p3 = config_params("c3_full_1080p")
    fps, compile_s, stage_s = bench_engine(p3, h, w, batch, iters)
    log(f"c3 full-stack {w}x{h}: {fps:.1f} fps "
        f"(stage {stage_s:.1f}s, compile+first {compile_s:.1f}s)")

    cpu_fps = bench_oracle(p3, h, w, oracle_frames)
    log(f"c3 CPU oracle {w}x{h}: {cpu_fps:.2f} fps (live)")
    if not quick:
        cpu_fps = max(cpu_fps, PINNED_CPU_BASELINE_FPS)
        log(f"c3 CPU baseline used: {cpu_fps:.2f} fps "
            f"(pinned reference {PINNED_CPU_BASELINE_FPS})")

    if run_all:
        # c4 at its NOMINAL size: (h, w) is already the quick stand-in
        # under --quick, and the branch below halves again
        sizes = {"c1_defaults_480p": (480, 640), "c2_retro_720p": (720, 1280),
                 "c4_temporal_1080p": (1080, 1920)}
        for name, (ch, cw) in sizes.items():
            if quick:
                ch, cw = ch // 2, cw // 2
            cfps, cs, ss = bench_engine(config_params(name), ch, cw, batch,
                                        iters)
            pin = PINNED_CPU_BASELINE.get(name)
            vs = f", vs_baseline {cfps / pin:.0f}x (ref {pin} fps)" \
                if pin and not quick else ""
            log(f"{name} {cw}x{ch}: {cfps:.1f} fps (stage {ss:.1f}s, "
                f"compile+first {cs:.1f}s){vs}")
        log(f"c5 (multi-clip 4K): {bench_c5(quick):.1f} fps")

    print(json.dumps({
        "metric": f"1080p frames/sec/GPU, full effect stack ({w}x{h})",
        "value": round(fps, 1),
        "unit": "fps",
        "vs_baseline": round(fps / max(cpu_fps, 1e-9), 1),
    }))


if __name__ == "__main__":
    main()
