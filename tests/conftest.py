"""Test harness setup.

Tests run on a CPU backend with 8 virtual devices, so multi-device
sharding is exercised without accelerators (SURVEY.md §4 item 5); the
GPU path is checked by chip_smoke.py on the card.
"""

import os
import sys

_WANT_XLA = "--xla_force_host_platform_device_count=8"

if _WANT_XLA not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " " + _WANT_XLA).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def synth_frames(n, h, w, seed=0):
    """Synthetic clip frames exercising gradients, checkerboards, impulses,
    and random texture (impulses expose blur/warp kernels directly)."""
    rng = np.random.default_rng(seed)
    frames = []
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        kind = i % 4
        if kind == 0:  # diagonal gradient
            f = ((xx + yy + 7 * i) % 256).astype(np.int32)
            f = np.stack([f, 255 - f, (f * 2) % 256], axis=-1).astype(np.uint8)
        elif kind == 1:  # checkerboard
            f = (((xx // 4 + yy // 4 + i) % 2) * 255).astype(np.uint8)
            f = np.stack([f, f, f], axis=-1)
        elif kind == 2:  # impulses on black
            f = np.zeros((h, w, 3), np.uint8)
            pts = rng.integers(0, [h, w], size=(16, 2))
            f[pts[:, 0], pts[:, 1]] = 255
        else:  # random texture
            f = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        frames.append(f)
    return np.stack(frames)


@pytest.fixture
def frames_small():
    return synth_frames(8, 48, 64)

