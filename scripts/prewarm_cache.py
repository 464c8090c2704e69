"""Populate the persistent XLA compilation cache for the standard
configs, so production renders / GUI preview tweaks never pay the cold
compile (every new (preset, resolution) pays a compile before frame 1;
the reference starts instantly because it never compiles —
crt_filter.py:2352).

Usage:
  python scripts/prewarm_cache.py [--configs c1,c2,c3,c4] \
      [--sizes 480p,720p,1080p,4k] [--batch 32] [--spc 8,1]

Each (config, size, spc) pair lowers+compiles the engine step into
$JAX_COMPILATION_CACHE_DIR, or .jax_cache/ in the checkout (GPU only).
Re-running is cheap: already-cached programs compile in seconds. Run it once per
toolchain bump, ideally from CI or a deploy hook.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIZES = {"480p": (480, 640), "720p": (720, 1280),
         "1080p": (1080, 1920), "4k": (2160, 3840)}
# bench/BASELINE geometry per config
DEFAULT_PLAN = [("c1_defaults_480p", "480p"), ("c2_retro_720p", "720p"),
                ("c3_full_1080p", "1080p"), ("c4_temporal_1080p", "1080p"),
                ("c4_temporal_1080p", "4k")]


def prewarm(cfg: str, size: str, batch: int, spc: int) -> float:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import config_params, make_frames
    from pythoncrt_tpu.engine import CRTEngine

    h, w = SIZES[size]
    t0 = time.perf_counter()
    eng = CRTEngine(config_params(cfg), h, w, fps=30.0)
    frames = make_frames(spc * batch, h, w, seed=1)
    aux = eng.make_aux(np.arange(spc * batch))
    state = eng.init_state()
    first = jnp.zeros((1,), jnp.bool_)
    if spc > 1:
        frames = frames.reshape((spc, batch) + frames.shape[1:])
        aux = jax.tree.map(
            lambda a: jnp.reshape(a, (spc, batch) + a.shape[1:]), aux)
        jax.jit(eng._multi_step).lower(
            frames, aux, state, first, eng._c).compile()
    else:
        jax.jit(eng._step).lower(frames, aux, state, first, eng._c).compile()
    return time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="")
    ap.add_argument("--sizes", default="")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--spc", default="8",
                    help="comma list of steps-per-call variants to warm")
    a = ap.parse_args()

    if a.configs or a.sizes:
        cfgs = (a.configs or "c3_full_1080p").split(",")
        sizes = (a.sizes or "1080p").split(",")
        plan = [(c, s) for c in cfgs for s in sizes]
    else:
        plan = DEFAULT_PLAN
    spcs = [int(s) for s in a.spc.split(",")]

    import jax

    from pythoncrt_tpu.engine import COMPILE_CACHE_DIR

    # the engine enables the persistent cache at first construction
    # (engine._enable_compile_cache); report the destination up front
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR",
                               COMPILE_CACHE_DIR)
    print(f"backend: {jax.default_backend()}; cache: {cache_dir}",
          file=sys.stderr)
    for cfg, size in plan:
        for spc in spcs:
            # pipeline auto-spc: 8 at <=1080p, 4 above (pipeline.py)
            eff = spc if SIZES[size][0] <= 1080 else min(spc, 4)
            dt = prewarm(cfg, size, a.batch, eff)
            print(f"{cfg} {size} spc={eff}: {dt:.1f}s", flush=True)


if __name__ == "__main__":
    main()
