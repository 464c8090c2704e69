"""Reference render of a batch: the oracle chain frame by frame plus the
serial persistence blend, fed the same per-frame inputs the engine
consumed. The referee the tests and chip_smoke.py compare
CRTEngine.process with (<= 1 LSB per channel after the uint8 round
trip)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import ops
from .engine import apply_effects, persistence_blend


def render_oracle(eng, frames: np.ndarray, indices=None,
                  text_rgba: Optional[np.ndarray] = None) -> np.ndarray:
    """(B, H, W, 3) uint8 frames -> (B, H, W, 3) uint8 reference output
    for a CRTEngine `eng` (the stream starts at the first frame).

    The per-frame aux (scanline phase, host-rng noise fields) comes from
    eng.make_aux, so an engine built with rng="host" sees exactly the
    same draws. text_rgba is the overlay the engine was built with."""
    p = eng.params
    b = frames.shape[0]
    indices = np.arange(b) if indices is None else np.asarray(indices)
    aux = eng.make_aux(indices)
    phase = np.asarray(aux.phase)
    noise = None if aux.noise is None else np.asarray(aux.noise)
    outs, prev = [], None
    for j in range(b):
        img = apply_effects(
            frames[j], p,
            phase_px=float(phase[j]), time_sec=float(indices[j]) / eng.fps,
            noise_field=None if noise is None else noise[j],
            text_rgba=text_rgba,
            engine=eng.engine,
        )
        img = persistence_blend(
            prev, img, p.persistence if p.persistence_on else 0.0)
        prev = img
        outs.append(ops.to_uint8(img))
    return np.stack(outs)
