"""Dump the optimized HLO of the c3/c4 engine step (compile only, no
execution). Ground truth for which ops live in which fusion — pairs
with the per-stage device times of scripts/stage_times.py.

Usage: python scripts/dump_hlo.py [c3|c4] [--out /tmp/hlo_c3.txt]
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import config_params, make_frames  # noqa: E402


def main() -> None:
    cfg = "c3"
    out = None
    for i, a in enumerate(sys.argv):
        if a in ("c3", "c4"):
            cfg = a
        if a == "--out":
            out = sys.argv[i + 1]
    out = out or f"/tmp/hlo_{cfg}.txt"

    import jax
    import jax.numpy as jnp

    from pythoncrt_tpu.engine import CRTEngine

    h, w, batch = 1080, 1920, 32
    name = "c3_full_1080p" if cfg == "c3" else "c4_temporal_1080p"
    eng = CRTEngine(config_params(name), h, w, fps=30.0)
    frames = jnp.asarray(make_frames(batch, h, w))
    aux = eng.make_aux(np.arange(batch))
    state = eng.init_state()
    first = jnp.zeros((1,), jnp.bool_)
    lowered = jax.jit(eng._step).lower(frames, aux, state, first, eng._c)
    compiled = lowered.compile()
    txt = compiled.as_text()
    with open(out, "w") as f:
        f.write(txt)
    print(f"wrote {len(txt)} bytes to {out}", flush=True)


if __name__ == "__main__":
    main()
